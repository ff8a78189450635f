"""Operations, bytes and least times of DELiVR's BasicUNet forward, and the
H100's peaks: the yardstick that the per-layer metrics divide by.

``conv_shapes``, ``conv_bound_s`` and ``pack_bytes`` are frozen copies of
the arithmetic of the repository's ``chip_smoke.py`` (``conv_shapes``,
``bound_ms``, ``pack_bytes``), kept here so that a change to the program
cannot move the yardstick. The work is counted from the model's widths and
the windows the inputs need, never from kernel launches.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet (NVIDIA H100 Tensor Core GPU, product
# brief), dense rates without sparsity, at the 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def conv_shapes(features, roi):
    """(name, level, C1, C2, C_out, D, H, W) of the 18 3×3×3 convs of one
    forward, in call order (C2 > 0: the UpCat's conv over skip ⧺ upsampled)."""
    f = features
    rows = [("conv_0.0", 0, 1, 0, f[0]), ("conv_0.1", 0, f[0], 0, f[0])]
    for i in range(1, 5):
        rows += [(f"down_{i}.0", i, f[i - 1], 0, f[i]),
                 (f"down_{i}.1", i, f[i], 0, f[i])]
    for i, (skip, up, out) in zip(
        (4, 3, 2, 1),
        ((f[3], f[3], f[3]), (f[2], f[2], f[2]), (f[1], f[1], f[1]),
         (f[0], f[1], f[5])),
    ):
        rows += [(f"upcat_{i}.0", i - 1, skip, up, out),
                 (f"upcat_{i}.1", i - 1, out, 0, out)]
    return [(n, lvl, c1, c2, co, roi[0] >> lvl, roi[1] >> lvl, roi[2] >> lvl)
            for n, lvl, c1, c2, co in rows]


def deconv_shapes(features, roi):
    """(name, C_in, C_out, D, H, W at the input) of the four stride-2
    transposed convs of one forward."""
    f = features
    rows = [("upcat_4", f[4], f[3], 4), ("upcat_3", f[3], f[2], 3),
            ("upcat_2", f[2], f[1], 2), ("upcat_1", f[1], f[1], 1)]
    return [(n, ci, co, roi[0] >> lvl, roi[1] >> lvl, roi[2] >> lvl)
            for n, ci, co, lvl in rows]


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


def convs_bound_s(features, roi, windows: float, weight_reads: int = 1) -> float:
    """The least time of every 3×3×3 conv of the forwards of ``windows``
    windows, the weights of each conv read ``weight_reads`` times in all."""
    total = 0.0
    for _, _, c1, c2, co, d, h, w in conv_shapes(features, roi):
        total += conv_bound_s(windows, d, h * w, c1 + c2, co, True, weight_reads)
    return total


def forward_flops(features, roi, out_channels=1) -> dict:
    """Operations of one window's forward by kind: the 3×3×3 convs, the
    stride-2 transposed convs (each output voxel takes C_in products from
    one tap) and the final 1×1×1 conv."""
    conv = sum(conv_ops_bytes(1, d, h * w, c1 + c2, co)[0]
               for _, _, c1, c2, co, d, h, w in conv_shapes(features, roi))
    deconv = sum(2.0 * ci * co * 8 * d * h * w
                 for _, ci, co, d, h, w in deconv_shapes(features, roi))
    vox = roi[0] * roi[1] * roi[2]
    final = 2.0 * features[5] * out_channels * vox
    return {"conv3x3x3": conv, "deconv": deconv, "final": final,
            "total": conv + deconv + final}
