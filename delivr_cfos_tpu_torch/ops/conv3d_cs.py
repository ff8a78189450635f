"""3×3×3 SAME convolution on (B, D, C, H·W) bf16 activations.

``conv3d_cs`` launches the hand-written CUDA kernels of ``csrc/conv3d_cs.cu``
(the counterpart of the TPU kernel ``delivr_cfos_tpu/ops/pallas/
conv3d_cs.py:374``) on a CUDA tensor and runs ``conv3d_cs_reference``, its
plain PyTorch version, on a CPU tensor. Every other device raises.

Contract, as on the TPU: f32 accumulation, bf16 output; optional ``bias``;
``emit_stats`` adds the per-plane (Σx, Σx²) of the f32 output before
rounding, (B, D, 2, C_out) f32; ``pair=(x2, w2[, bias2])`` convolves
concat([x, bf16(x2 + bf16(bias2))]); ``in_affine=(a, c)`` applies
bf16(mish(x·a + c)) to the input. Odd C_in is taken as is.

Three paths on the card, by a fixed shape rule (``conv3d_cs_path``):
``packed`` — ``conv3d_cs_pack`` writes the conv's input once as xp (B, D+2,
H+2, W+2, Cp), zero-padded, channels innermost, with the concat, pair bias
and prologue applied and the channels padded with zeros to the packed
conv's K step of 16 (``packed_channels``), and the packed conv kernel reads
it with 16-byte copies, one block a plane where its ring of stages fits a
block (``packed_smem_bytes``), else its wide instance (``packed_wide``):
tiles of 4 × 64 outputs, whose stages do not grow with W, spread over
blocks;
``direct`` for C_in = 1 with W and C_out multiples of 8 (the first conv), a
stencil of f32 FMAs on input planes staged in shared memory; and ``narrow``
for C1 + C2 ≤ ``NARROW_MAX`` (the packed first conv, narrow models),
tensor-core MMAs on input planes staged in shared memory once per band,
channels innermost, with resident weights.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.ops import _build
from delivr_cfos_tpu_torch.utils.device import full_f32

TN = 32  # output channels per block of the packed conv
# voxels of storage past xp's end: the largest tile plus one, which the last
# tile's dz = 2 span reads past it (the wide instance reads none)
TAIL = 257
DIRECT_MAX_W = 2048  # widest plane the direct conv takes (bands of 2 rows)
DIRECT_BAND_BYTES = 100 * 1024  # f32 input rows a direct block stages: 2 blocks an SM
NARROW_MAX = 16  # C1 + C2 the narrow conv takes (the kernel's NARROW_MAX_C)
NARROW_SMEM_BYTES = 112 * 1024  # shared memory of a narrow block: 2 blocks an SM
NARROW_PASS = 32  # output channels a narrow block computes per pass over its staged input
# the narrow kernel's fixed shared memory besides weights and input: 8 warps'
# epilogue tiles (32 channels × 40 bf16) and stats partials (2 × 32 f32)
_NARROW_FIXED = 8 * 32 * 40 * 2 + 8 * 2 * 32 * 4
PACKED_K = 16  # channel slots a K step of the packed conv (the kernel's PCC)
PACKED_STAGES = 3  # the packed conv's ring of stages (the kernel's STAGES)
SMEM_OPTIN = 232_448  # shared memory an H100 block may opt into
# the packed conv's wide instance: tiles of WIDE_ROWS × WIDE_COLS outputs
WIDE_COLS = 64
WIDE_ROWS = 4
WIDE_BLOCKS_PER_SM = 2  # its resident blocks (256 threads, its registers)


def _mish(v: torch.Tensor) -> torch.Tensor:
    return v * torch.tanh(F.softplus(v))


def _split_pair(pair):
    if pair is None:
        return None, None, None
    x2, w2 = pair[0], pair[1]
    return x2, w2, (pair[2] if len(pair) > 2 else None)


def conv3d_cs_path(c1: int, c2: int, w: int, cout: int) -> str:
    """The kernel path a CUDA call with C1 and C2 input channels, planes W
    wide and C_out output channels takes: packed without padding where C1
    and C2 are multiples of 16, then direct, then narrow, then packed with
    the channels padded to ``packed_channels``. Planes too wide for the
    packed ring take the packed conv's wide instance (``packed_wide``)."""
    if c1 % 16 == 0 and c2 % 16 == 0:
        return "packed"
    if c1 == 1 and c2 == 0 and w % 8 == 0 and w <= DIRECT_MAX_W and cout % 8 == 0:
        return "direct"
    if _narrow_takes(c1 + c2, w):
        return "narrow"
    return "packed"


def _pad8(c: int) -> int:
    return -(-c // 8) * 8


def packed_channels(c1: int, c2: int) -> int:
    """Channel slots of the pack's xp (the kernel's packed_channels): C1 and
    C2 each padded to a multiple of 8, their sum to a multiple of
    ``PACKED_K``. Slots [0, C1) hold x, [C1p, C1p + C2) x2, the rest zeros."""
    return -(-(_pad8(c1) + _pad8(c2)) // PACKED_K) * PACKED_K


def packed_smem_bytes(tm: int, w: int) -> int:
    """Shared memory of a packed-conv block with ``tm``-row tiles on planes W
    wide (the kernel's STAGES · packed_stage_elems · 2): 3 stages, each a
    span of tm + 2(W + 2) + 2 voxels at 24 bf16 a voxel and 9 × 16 weight
    rows of 40 bf16. ``packed_wide`` asks at 256 rows, the tiles of every
    plane wider than 126 columns (``packed_tile_rows``)."""
    return PACKED_STAGES * ((tm + 2 * (w + 2) + 2) * (PACKED_K + 8) + 9 * PACKED_K * (TN + 8)) * 2


def packed_wide(w: int) -> bool:
    """Whether the packed conv takes planes W wide with its wide instance:
    where its ring of stages at 256-row tiles, the tiles of every plane
    wider than 126 columns, does not fit a block (W > 556)."""
    return packed_smem_bytes(256, w) > SMEM_OPTIN


def wide_smem_bytes() -> int:
    """Shared memory of a block of the wide instance (the kernel's STAGES ·
    wide_stage_elems · 2): 3 stages, each the (WIDE_ROWS + 2) × (WIDE_COLS +
    2) voxels around a tile at 24 bf16 a voxel and 9 × 16 weight rows of 40
    bf16, whatever W is."""
    return PACKED_STAGES * ((WIDE_ROWS + 2) * (WIDE_COLS + 2) * (PACKED_K + 8)
                            + 9 * PACKED_K * (TN + 8)) * 2


def wide_tile_groups(h: int, w: int, planes: int, cout: int, cin: int,
                     sms: int) -> tuple[int, int]:
    """(tiles a block, groups a plane) of the wide instance on ``planes``
    H×W planes of ``cin`` channel slots: the plane's ⌈H/4⌉·⌈W/64⌉ tiles, row
    by row, in groups of equal tiles (the last may have fewer), the grid
    (⌈C_out/32⌉, groups, ``planes``). The groups minimise the waves of
    ``WIDE_BLOCKS_PER_SM`` blocks on ``sms`` SMs times a block's stages (3 ·
    C/16 a tile, and the 2 its ring loads before its first MMA), among the
    grids of at least one such wave where there are tiles enough; on a tie
    the larger groups, which write fewer stats partials."""
    tiles = -(-h // WIDE_ROWS) * -(-w // WIDE_COLS)
    per_group = planes * -(-cout // TN)  # blocks a tile group
    stages = 3 * -(-cin // PACKED_K)
    slots = WIDE_BLOCKS_PER_SM * sms
    best = None
    for groups in range(1, tiles + 1):
        per = -(-tiles // groups)
        if -(-tiles // per) != groups:
            continue  # the same tiles a block as fewer groups
        blocks = per_group * groups
        if blocks < slots and per_group * tiles >= slots:
            continue
        cost = -(-blocks // slots) * (per * stages + PACKED_STAGES - 1)
        if best is None or cost < best[0]:
            best = (cost, per, groups)
    return best[1], best[2]


def narrow_k(cin: int) -> int:
    """K of the narrow conv: 27 taps × C_in padded to even, padded to 16."""
    return -(-27 * (cin + cin % 2) // 16) * 16


def narrow_smem_bytes(cin: int, rows: int, w: int) -> int:
    """Shared memory of a narrow block (the kernel's narrow_smem_bytes):
    epilogue tiles, stats partials, one pass's weights, the K-pair offsets
    and three bf16 input planes of ``rows`` + 2 rows × (W + 2) voxels."""
    ce, kp = cin + cin % 2, narrow_k(cin)
    return (_NARROW_FIXED + NARROW_PASS * (kp + 8) * 2 + kp // 2 * 4
            + 3 * (rows + 2) * (w + 2) * ce * 2)


def _narrow_fit_rows(cin: int, w: int) -> int:
    """Most output rows a narrow block's band holds within
    ``NARROW_SMEM_BYTES`` (below 1: not one row fits)."""
    per_row = 3 * (w + 2) * (cin + cin % 2) * 2
    return (NARROW_SMEM_BYTES - narrow_smem_bytes(cin, 0, w)) // per_row


def _narrow_takes(cin: int, w: int) -> bool:
    """Whether the narrow conv takes C_in input channels on planes W wide."""
    return cin <= NARROW_MAX and _narrow_fit_rows(cin, w) >= 1


def narrow_band_rows(cin: int, h: int, w: int) -> int:
    """Output rows a narrow block stages at once: the whole plane where it
    fits (the packed first conv's 96 × 64 plane at C_in = 2), else the
    fewest bands that fit, of equal rows."""
    fit = min(h, _narrow_fit_rows(cin, w))
    if fit < 1:
        raise ValueError(f"the narrow conv cannot stage one row of {w} voxels × {cin} channels")
    return -(-h // -(-h // fit))


def direct_band_rows(h: int, w: int) -> int:
    """Output rows a block of the direct conv stages at once: the whole
    plane where its three f32 input planes with their halo fit in
    ``DIRECT_BAND_BYTES`` (the 96×64 first-conv plane: 79,968 bytes), else
    as many rows as fit."""
    return min(h, DIRECT_BAND_BYTES // (3 * 4 * (w + 4)) - 2)


def packed_tile_rows(h: int, w: int) -> int:
    """Output rows per tile of the packed conv: 256 where the padded plane
    has more than 128 virtual voxels (levels 0-2 of the production window),
    else 128, which wastes less of a small plane's one tile."""
    return 256 if h * (w + 2) > 128 else 128


def conv3d_cs_pack_reference(x, *, h, w, x2=None, bias2=None, in_affine=None,
                             padded=False):
    """Plain PyTorch version of ``conv3d_cs_pack``: (B, D+2, H+2, W+2,
    C1+C2) bf16 with zeros around, channel ci of x, or of bf16(x2 +
    bf16(bias2)) for ci ≥ C1, then bf16(mish(v·a + c)) with ``in_affine``.
    ``padded``: the kernel's layout, ``packed_channels(C1, C2)`` slots,
    x in [0, C1), x2 in [C1p, C1p + C2) and exact zeros elsewhere."""
    xf = x.to(torch.bfloat16).float()
    c1 = xf.shape[2]
    if x2 is not None:
        x2f = x2.to(torch.bfloat16).float()
        if bias2 is not None:
            b2 = bias2.to(torch.bfloat16).float()[None, None, :, None]
            x2f = (x2f + b2).to(torch.bfloat16).float()
        xf = torch.cat([xf, x2f], dim=2)
    if in_affine is not None:
        a, c = in_affine
        v = xf * a.float()[:, None, :, None] + c.float()[:, None, :, None]
        xf = _mish(v)
    b_, d, cin, _ = xf.shape
    if padded:
        slots = xf.new_zeros((b_, d, packed_channels(c1, cin - c1), h * w))
        slots[:, :, :c1] = xf[:, :, :c1]
        slots[:, :, _pad8(c1):_pad8(c1) + cin - c1] = xf[:, :, c1:]
        xf, cin = slots, slots.shape[2]
    xp = torch.zeros((b_, d + 2, h + 2, w + 2, cin), dtype=torch.bfloat16,
                     device=x.device)
    xp[:, 1:-1, 1:-1, 1:-1] = xf.reshape(b_, d, cin, h, w).permute(0, 1, 3, 4, 2)
    return xp


def conv3d_cs_packed_reference(xp, w_blk, bias, *, cout, emit_stats=False):
    """Plain PyTorch version of ``conv3d_cs_packed``: the 3×3×3 VALID conv of
    ``xp`` (B, D+2, H+2, W+2, C) bf16 with ``w_blk`` (⌈C_out/32⌉, 27·C, 32)
    from ``block_weights``, in f32 without TF32, the bias added in f32;
    (B, D, C_out, H·W) bf16 and, with ``emit_stats``, the per-plane (Σx, Σx²)
    of the f32 output."""
    b_, dp, hp, wp, cin = xp.shape
    d, h, w = dp - 2, hp - 2, wp - 2
    w_k = w_blk.permute(1, 0, 2).reshape(27 * cin, -1)[:, :cout]
    w5 = w_k.float().reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    with full_f32():
        y = F.conv3d(xp.float().permute(0, 4, 1, 2, 3), w5)
    if bias is not None:
        y = y + bias.float()[None, :, None, None, None]
    y = y.permute(0, 2, 1, 3, 4).reshape(b_, d, cout, h * w)
    out = y.to(torch.bfloat16, memory_format=torch.contiguous_format)  # as the kernel's
    if not emit_stats:
        return out
    return out, torch.stack([y.sum(dim=3), (y * y).sum(dim=3)], dim=2)


def conv3d_cs_reference(x, weights, bias, *, h, w, in_affine=None,
                        emit_stats=False, pair=None):
    """Plain PyTorch version of ``conv3d_cs`` with the kernel's roundings:
    the input built by ``conv3d_cs_pack_reference`` (inputs rounded to
    bf16, the pair bias rounded to bf16 and added in f32 with one rounding,
    the affine prologue rounded to bf16), weights rounded to bf16, then
    ``conv3d_cs_packed_reference``: an f32 convolution without TF32, stats
    from the f32 output."""
    if pair is not None and in_affine is not None:
        raise ValueError("pair mode is incompatible with in_affine")
    x2, w2, bias2 = _split_pair(pair)
    xp = conv3d_cs_pack_reference(x, h=h, w=w, x2=x2, bias2=bias2,
                                  in_affine=in_affine)
    return conv3d_cs_packed_reference(xp, block_weights(kernel_weights(weights, w2)), bias,
                                      cout=weights.shape[-1], emit_stats=emit_stats)


def _check(t, name, dtype, shape, device):
    """Raise unless ``t`` has this device, shape and (when ``dtype`` is not
    None) dtype and is contiguous; weights may be any float view."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dtype is not None and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _inputs(x, h, w, x2, bias2, in_affine):
    """Check the activations and prologue arguments of a CUDA call; returns
    (bias2 as bf16, a, c) ready for the kernels."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_cs runs on CUDA or the CPU, not {x.device}")
    if x2 is not None and in_affine is not None:
        raise ValueError("pair mode is incompatible with in_affine")
    dev = x.device
    if x.dim() != 4:
        raise ValueError(f"x must be (B, D, C, H·W), got shape {tuple(x.shape)}")
    b_, n_d, c1, s = x.shape
    if s != h * w:
        raise ValueError(f"plane size {s} != h·w = {h}·{w}")
    _check(x, "x", torch.bfloat16, (b_, n_d, c1, s), dev)
    c2 = 0 if x2 is None else x2.shape[2]
    if x2 is not None:
        _check(x2, "x2", torch.bfloat16, (b_, n_d, c2, s), dev)
    pb = None
    if bias2 is not None:
        pb = bias2.to(device=dev, dtype=torch.bfloat16).contiguous()
        _check(pb, "bias2", torch.bfloat16, (c2,), dev)
    a = c = None
    if in_affine is not None:
        a, c = (t.to(torch.float32).contiguous() for t in in_affine)
        _check(a, "in_affine a", torch.float32, (b_, c1 + c2), dev)
        _check(c, "in_affine c", torch.float32, (b_, c1 + c2), dev)
    return pb, a, c


def conv3d_cs_pack(x, *, h, w, x2=None, bias2=None, in_affine=None):
    """The packed conv input: (B, D+2, H+2, W+2, ``packed_channels(C1, C2)``)
    bf16 from ``x`` (B, D, C1, H·W) bf16 and, in pair mode, ``x2`` (B, D,
    C2, H·W) bf16 with its ``bias2``, the channels in the slots of
    ``conv3d_cs_pack_reference(..., padded=True)``. On the card its storage
    runs ``TAIL`` voxels past its end (never written), which the packed conv
    may read into rows it drops."""
    if x.device.type == "cpu":
        return conv3d_cs_pack_reference(x, h=h, w=w, x2=x2, bias2=bias2,
                                        in_affine=in_affine, padded=True)
    pb, a, c = _inputs(x, h, w, x2, bias2, in_affine)
    b_, n_d, c1, _ = x.shape
    c2 = 0 if x2 is None else x2.shape[2]
    cp = packed_channels(c1, c2)
    shape = (b_, n_d + 2, h + 2, w + 2, cp)
    n = b_ * (n_d + 2) * (h + 2) * (w + 2) * cp
    xp = torch.empty(n + TAIL * cp, dtype=torch.bfloat16, device=x.device)[:n].view(shape)
    lib = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3d_cs_pack_launch(
            _ptr(x), _ptr(x2), _ptr(pb), _ptr(a), _ptr(c), _ptr(xp),
            b_, n_d, c1, c2, h, w, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"conv3d_cs_pack kernel launch failed: CUDA error {err}")
    conv3d_cs_pack.launches += 1
    if cp != c1 + c2:
        conv3d_cs_pack.padded_launches += 1
    return xp


# launches, and those of them that wrote pad slots (Cp > C1 + C2)
conv3d_cs_pack.launches = 0
conv3d_cs_pack.padded_launches = 0


def kernel_weights(weights, w2=None, *, padded=False):
    """DHWIO weights (and pair mode's ``w2``) → (27·C_in, C_out) bf16, row
    k = ((dz·3 + dy)·3 + dx)·C_in + ci. ``padded``: the pack's slots,
    (27·Cp, C_out) with Cp = ``packed_channels(C1, C2)``, row tap·Cp + slot,
    zero rows at the pad slots."""
    c1, cout = weights.shape[3], weights.shape[4]
    c2 = 0 if w2 is None else w2.shape[3]
    if not padded or packed_channels(c1, c2) == c1 + c2:
        ws = [weights] if w2 is None else [weights, w2]
        return torch.cat(ws, dim=3).to(torch.bfloat16).reshape(-1, cout).contiguous()
    out = torch.zeros((27, packed_channels(c1, c2), cout), dtype=torch.bfloat16,
                      device=weights.device)
    out[:, :c1] = weights.reshape(27, c1, cout)
    if w2 is not None:
        out[:, _pad8(c1):_pad8(c1) + c2] = w2.reshape(27, c2, cout)
    return out.reshape(-1, cout)


def narrow_weights(weights, w2=None):
    """DHWIO weights (and pair mode's ``w2``) → the narrow conv's layout,
    (⌈C_out/8⌉·8, ``narrow_k(C_in)``) bf16: row n holds output channel n's
    K values, k = ((dz·3 + dy)·3 + dx)·C_e + ci with C_e = C_in padded to
    even; zeros for the pad channel, past 27·C_e and past C_out. One zero
    fill and one cast-copy per input (the module weights' DHWIO view is
    read in place)."""
    c1, cout = weights.shape[3], weights.shape[4]
    cin = c1 + (0 if w2 is None else w2.shape[3])
    ce = cin + cin % 2
    out = torch.zeros((-(-cout // 8) * 8, narrow_k(cin)), dtype=torch.bfloat16,
                      device=weights.device)
    taps = out[:cout, :27 * ce].view(cout, 27, ce)
    taps[:, :, :c1] = weights.reshape(27, c1, cout).permute(2, 0, 1)
    if w2 is not None:
        taps[:, :, c1:cin] = w2.reshape(27, cin - c1, cout).permute(2, 0, 1)
    return out


def block_weights(w_k):
    """(27·C_in, C_out) → the packed conv's layout, (⌈C_out/32⌉, 27·C_in, 32)
    bf16: C_out zero-padded to a multiple of 32 and cut into one block's
    contiguous tile."""
    k, cout = w_k.shape
    tiles = -(-cout // TN)
    wp = F.pad(w_k, (0, tiles * TN - cout))
    return wp.reshape(k, tiles, TN).permute(1, 0, 2).contiguous()


def _outputs(b_, n_d, cout, s, emit_stats, dev):
    out = torch.empty((b_, n_d, cout, s), dtype=torch.bfloat16, device=dev)
    stats = (
        torch.empty((b_, n_d, 2, cout), dtype=torch.float32, device=dev)
        if emit_stats else None
    )
    return out, stats


def conv3d_cs_packed(xp, w_blk, bias, *, cout, emit_stats=False, wide=False):
    """The packed conv kernel on the card: ``xp`` from ``conv3d_cs_pack``
    (B, D+2, H+2, W+2, Cp) with its tail, Cp a multiple of 16; ``w_blk``
    from ``block_weights(kernel_weights(..., padded=True))``, (⌈C_out/32⌉,
    27·Cp, 32). Its wide instance where ``packed_wide(W)`` or ``wide``.
    Returns what ``conv3d_cs`` returns; the plain version
    (``conv3d_cs_packed_reference``) on a CPU tensor."""
    dev = xp.device
    if dev.type == "cpu":
        return conv3d_cs_packed_reference(xp, w_blk, bias, cout=cout, emit_stats=emit_stats)
    if dev.type != "cuda":
        raise ValueError(f"the packed conv runs on CUDA or the CPU, not {dev}")
    b_, dp, hp, wp, cin = xp.shape
    n_d, h, w = dp - 2, hp - 2, wp - 2
    wide = wide or packed_wide(w)
    if cin % PACKED_K:
        raise ValueError(f"the packed conv needs C_in a multiple of {PACKED_K}, got {cin}")
    _check(xp, "xp", torch.bfloat16, xp.shape, dev)
    if xp.untyped_storage().nbytes() - xp.storage_offset() * 2 < (xp.numel() + TAIL * cin) * 2:
        raise ValueError(f"xp needs {TAIL} voxels of storage past its end (conv3d_cs_pack)")
    _check(w_blk, "w_blk", torch.bfloat16, (-(-cout // TN), 27 * cin, TN), dev)
    if bias is not None:
        _check(bias, "bias", torch.float32, (cout,), dev)
    out, stats = _outputs(b_, n_d, cout, h * w, emit_stats, dev)
    lib = _launcher()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if wide:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            per, groups = wide_tile_groups(h, w, b_ * n_d, cout, cin, sms)
            if b_ * n_d > 65535 or groups > 65535:
                raise ValueError(f"the wide instance takes at most 65535 planes and tile "
                                 f"groups, got {b_ * n_d} and {groups}")
            # the blocks' stats partials, summed by the kernel's second pass
            partials = (torch.empty((b_ * n_d, groups, 2, cout), dtype=torch.float32,
                                    device=dev) if emit_stats else None)
            err = lib.conv3d_cs_packed_wide_launch(
                _ptr(xp), _ptr(w_blk), _ptr(bias), _ptr(out), _ptr(stats), _ptr(partials),
                b_, n_d, cin, cout, h, w, per, stream)
        else:
            err = lib.conv3d_cs_packed_launch(
                _ptr(xp), _ptr(w_blk), _ptr(bias), _ptr(out), _ptr(stats),
                b_, n_d, cin, cout, h, w, packed_tile_rows(h, w), stream)
    if err != 0:
        raise RuntimeError(f"conv3d_cs kernel launch failed: CUDA error {err}")
    conv3d_cs.launches += 1
    conv3d_cs_packed.launches += 1
    conv3d_cs_packed.wide_launches += int(wide)
    return (out, stats) if emit_stats else out


# launches, and those of them on the wide instance
conv3d_cs_packed.launches = 0
conv3d_cs_packed.wide_launches = 0


def _checked(x, weights, bias, h, w, in_affine, pair):
    """Check a CUDA call's arguments; returns (x2, w2, bias2 as given, bias2
    as bf16, a, c)."""
    x2, w2, bias2 = _split_pair(pair)
    pb, a, c = _inputs(x, h, w, x2, bias2, in_affine)
    dev = x.device
    c1, cout = x.shape[2], weights.shape[-1]
    _check(weights, "weights", None, (3, 3, 3, c1, cout), dev)
    if x2 is not None:
        _check(w2, "w2", None, (3, 3, 3, x2.shape[2], cout), dev)
    if bias is not None:
        _check(bias, "bias", torch.float32, (cout,), dev)
    return x2, w2, bias2, pb, a, c


def _launch(fn, x, args, ints, emit_stats, cout):
    """Allocate the outputs of a conv kernel on (B, D, C, H·W), launch it
    with ``args`` (pointers, before the outputs) and ``ints`` (after them)
    on the current stream, and count the launch."""
    b_, n_d, _, s = x.shape
    out, stats = _outputs(b_, n_d, cout, s, emit_stats, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*map(_ptr, args), _ptr(out), _ptr(stats), *ints, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"conv3d_cs kernel launch failed: CUDA error {err}")
    conv3d_cs.launches += 1
    return (out, stats) if emit_stats else out


def _narrow(x, x2, pb, weights, w2, bias, a, c, h, w, emit_stats):
    b_, n_d, c1, _ = x.shape
    c2 = 0 if x2 is None else x2.shape[2]
    cout = weights.shape[-1]
    res = _launch(_launcher().conv3d_cs_narrow_launch, x,
                  (x, x2, pb, narrow_weights(weights, w2), bias, a, c),
                  (b_, n_d, c1, c2, cout, h, w, narrow_band_rows(c1 + c2, h, w)),
                  emit_stats, cout)
    conv3d_cs_narrow.launches += 1
    return res


def _direct(x, w_k, bias, a, c, h, w, emit_stats):
    b_, n_d, _, _ = x.shape
    cout = w_k.shape[1]
    res = _launch(_launcher().conv3d_cs_direct_launch, x, (x, w_k, bias, a, c),
                  (b_, n_d, cout, h, w, direct_band_rows(h, w)), emit_stats, cout)
    conv3d_cs_direct.launches += 1
    return res


def conv3d_cs(x, weights, bias, *, h, w, in_affine=None, emit_stats=False,
              pair=None):
    """3×3×3 SAME conv. ``x``: (B, D, C_in, H·W) bf16; ``weights``: DHWIO
    (3, 3, 3, C_in, C_out); ``bias``: (C_out,) or None. Returns (B, D, C_out,
    H·W) bf16, and (B, D, 2, C_out) f32 stats with ``emit_stats``."""
    if x.device.type == "cpu":
        return conv3d_cs_reference(
            x, weights, bias, h=h, w=w, in_affine=in_affine,
            emit_stats=emit_stats, pair=pair,
        )
    x2, w2, bias2, pb, a, c = _checked(x, weights, bias, h, w, in_affine, pair)
    c2 = 0 if x2 is None else x2.shape[2]
    cout = weights.shape[-1]
    path = conv3d_cs_path(x.shape[2], c2, w, cout)
    if path == "narrow":
        return _narrow(x, x2, pb, weights, w2, bias, a, c, h, w, emit_stats)
    if path == "packed":
        return _packed(x, weights, bias, h, w, in_affine, emit_stats, x2, w2, bias2, False)
    return _direct(x, kernel_weights(weights), bias, a, c, h, w, emit_stats)


def _packed(x, weights, bias, h, w, in_affine, emit_stats, x2, w2, bias2, wide):
    # xp is freed on return: the allocator orders its reuse on the stream
    xp = conv3d_cs_pack(x, h=h, w=w, x2=x2, bias2=bias2, in_affine=in_affine)
    return conv3d_cs_packed(xp, block_weights(kernel_weights(weights, w2, padded=True)),
                            bias, cout=weights.shape[-1], emit_stats=emit_stats, wide=wide)


def conv3d_cs_narrow(x, weights, bias, *, h, w, in_affine=None,
                     emit_stats=False, pair=None):
    """``conv3d_cs`` on the narrow kernel whatever the path rule says (the
    plain version on a CPU tensor); raises unless C1 + C2 ≤ ``NARROW_MAX``
    and a band of one row fits its shared memory."""
    if x.device.type == "cpu":
        return conv3d_cs_reference(
            x, weights, bias, h=h, w=w, in_affine=in_affine,
            emit_stats=emit_stats, pair=pair,
        )
    x2, w2, _, pb, a, c = _checked(x, weights, bias, h, w, in_affine, pair)
    cin = x.shape[2] + (0 if x2 is None else x2.shape[2])
    if not _narrow_takes(cin, w):
        raise ValueError(f"the narrow conv takes C1 + C2 <= {NARROW_MAX} on planes whose "
                         f"band of one row fits, got C_in {cin}, W {w}")
    return _narrow(x, x2, pb, weights, w2, bias, a, c, h, w, emit_stats)


def conv3d_cs_wide(x, weights, bias, *, h, w, in_affine=None,
                   emit_stats=False, pair=None):
    """``conv3d_cs`` on the pack and the packed conv's wide instance
    whatever the shape (the plain version on a CPU tensor): the path of
    planes too wide for the packed ring, and beside the other kernels at
    their shapes a yardstick of the wide ring."""
    if x.device.type == "cpu":
        return conv3d_cs_reference(
            x, weights, bias, h=h, w=w, in_affine=in_affine,
            emit_stats=emit_stats, pair=pair,
        )
    x2, w2, bias2, _, _, _ = _checked(x, weights, bias, h, w, in_affine, pair)
    return _packed(x, weights, bias, h, w, in_affine, emit_stats, x2, w2, bias2, True)


def conv3d_cs_direct(x, weights, bias, *, h, w, in_affine=None,
                     emit_stats=False):
    """``conv3d_cs`` on the direct kernel (the plain version on a CPU
    tensor); raises unless C_in = 1 and W and C_out are multiples of 8."""
    if x.device.type == "cpu":
        return conv3d_cs_reference(x, weights, bias, h=h, w=w, in_affine=in_affine,
                                   emit_stats=emit_stats)
    _, _, _, _, a, c = _checked(x, weights, bias, h, w, in_affine, None)
    if conv3d_cs_path(x.shape[2], 0, w, weights.shape[-1]) != "direct":
        raise ValueError("the direct conv takes C_in = 1 and W, C_out multiples of 8, "
                         f"got C_in {x.shape[2]}, W {w}, C_out {weights.shape[-1]}")
    return _direct(x, kernel_weights(weights), bias, a, c, h, w, emit_stats)


# launches of all conv kernels (18 a forward), and of each kernel alone
conv3d_cs.launches = 0
conv3d_cs_direct.launches = 0
conv3d_cs_narrow.launches = 0


def conv3d_cs_resources(path: str, h: int, w: int, cin: int = 2) -> tuple[int, int]:
    """(registers a thread, resident blocks an SM) of the conv kernel of
    ``path`` (``conv3d_cs_path``, or "wide": the packed conv's wide instance
    whatever W is) on an H×W plane (with ``cin`` input channels on the
    narrow path), as the card reports them."""
    if path == "packed" and packed_wide(w):
        path = "wide"
    tm = {"packed": packed_tile_rows(h, w), "wide": 3, "direct": 1, "narrow": 2}[path]
    rb = narrow_band_rows(cin, h, w) if path == "narrow" else direct_band_rows(h, w)
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = _launcher().conv3d_cs_resources(tm, rb, w, cin, ctypes.byref(regs),
                                          ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"conv3d_cs_resources failed: CUDA error {err}")
    return regs.value, blocks.value


def _launcher():
    lib = _build.load("conv3d_cs")
    if lib.conv3d_cs_packed_wide_launch.argtypes is None:
        lib.conv3d_cs_packed_wide_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.conv3d_cs_direct_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.conv3d_cs_pack_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.conv3d_cs_packed_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.conv3d_cs_narrow_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.conv3d_cs_resources.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2)
        for fn in (lib.conv3d_cs_packed_wide_launch, lib.conv3d_cs_direct_launch,
                   lib.conv3d_cs_pack_launch, lib.conv3d_cs_packed_launch,
                   lib.conv3d_cs_narrow_launch, lib.conv3d_cs_resources):
            fn.restype = ctypes.c_int
    return lib
