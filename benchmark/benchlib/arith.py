"""Operations, bytes and least times of the kernels, and the H100's peaks:
the yardstick that the per-layer metrics divide by.

A kernel's work is counted here from its shapes alone, so its roofline
counts the same work whatever model calls it; a model's shapes come from
the module that its configuration names (``benchmark/models/``), which the
metric readers load.
``conv_bound_s`` and ``pack_bytes`` are frozen copies of the arithmetic of
the repository's ``chip_smoke.py`` (``bound_ms``, ``pack_bytes``; the shapes
of ``models/basic_unet.py`` copy its ``conv_shapes``), kept apart from the
program so that a change to it cannot move the yardstick. The work is
counted from the model's widths and the windows the inputs need, never from
kernel launches.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet (NVIDIA H100 Tensor Core GPU, product
# brief), dense rates without sparsity, at the 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def conv_ops_bytes(b, d, s, cin, cout, emit_stats=True, weight_reads=1):
    """Operations and bytes of one 3×3×3 conv over ``b`` windows of
    (d, s = h·w) voxels in bf16: each input byte read once, each output
    written once, the weights read ``weight_reads`` times, and the f32
    per-plane (Σx, Σx²) that the fast forward's convs emit."""
    flops = 2.0 * 27 * cin * cout * b * d * s
    nbytes = 2.0 * b * d * s * (cin + cout) + weight_reads * 2.0 * 27 * cin * cout
    if emit_stats:
        nbytes += 4.0 * b * d * 2 * cout
    return flops, nbytes


def conv_bound_s(b, d, s, cin, cout, emit_stats=True, weight_reads=1):
    """The least time of that conv on the card: the larger of its
    operations at the bf16 peak and its bytes at the HBM peak."""
    flops, nbytes = conv_ops_bytes(b, d, s, cin, cout, emit_stats, weight_reads)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def pack_bytes(b, d, h, w, cin):
    """Bytes the conv's input staging must move: the input read once, the
    padded copy written once, at the real channel count."""
    return 2.0 * b * d * h * w * cin + 2.0 * b * (d + 2) * (h + 2) * (w + 2) * cin


def convs_bound_s(shapes, windows: float, weight_reads: int = 1) -> float:
    """The least time of the 3×3×3 convs ``shapes`` ((name, C_in, C_out, D,
    H, W) of one window's forward, as a model module's ``conv3d_cs_shapes``
    gives them) over ``windows`` windows, the weights of each conv read
    ``weight_reads`` times in all."""
    total = 0.0
    for _, cin, co, d, h, w in shapes:
        total += conv_bound_s(windows, d, h * w, cin, co, True, weight_reads)
    return total
