"""Sliding-window UNet inference over a volume held in device memory.

The counterpart of ``delivr_cfos_tpu/engine/sliding_window.py::infer_volume``,
with the reference's semantics (reference: inference/
sliding_window_inferer.py):

- the dense window grid: per-dim stride ``int(roi·(1−overlap))`` and clamped
  last-window starts (MONAI ``dense_patch_slices``);
- background windows (window max ≤ threshold) skip the model and add the
  constant −1000 logit (sliding_window_inferer.py:197-202);
- TTA: 1 base pass + 4 × (noise, noise + flip-z, noise + flip-y) = 13 passes,
  Gaussian noise of std 1e-3 on the f32 windows (inference.py:269-279);
- constant importance by default (the reference fork's quirk), or MONAI's
  Gaussian map;
- f32 accumulation on the device, then acc / count.

PyTorch runs eagerly, so the accumulators are updated in place by slice-adds
(the JAX package donates them to jitted steps instead), and the last window
batch of a chunk simply runs smaller: no padding to a static batch shape.
TTA noise comes from a ``torch.Generator`` seeded with ``cfg.seed`` on the
volume's device; it cannot reproduce ``jax.random``'s bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNet,
    BasicUNetConfig,
    basic_unet_apply,
)
from delivr_cfos_tpu_torch.ops.morphology import binarize_logits

SKIP_LOGIT = -1000.0  # constant emitted for background windows (reference)
_HOST_DEFAULT_BYTES = 16 * 2**30  # assumed device memory off CUDA


@dataclass(frozen=True)
class SlidingWindowConfig:
    roi: tuple = (96, 96, 64)  # (z, y, x), config.json:24-28
    overlap: float = 0.5  # inference.py:125
    # 0 = size the window batch from device memory (auto_batch_size)
    batch_size: int = 0
    background_threshold: int = 0  # sliding_window_inferer.py:50
    tta: bool = False
    tta_noise_std: float = 1e-3  # sliding_window_inferer.py:215
    threshold: float = 0.5  # sigmoid cutoff, inference.py:120
    erosion_iters: int = 30  # inference.py:84
    seed: int = 0
    # "constant" (reference quirk, sliding_window_inferer.py:148) or
    # "gaussian" (MONAI compute_importance_map)
    importance: str = "constant"
    importance_sigma_scale: float = 0.125


def _device_bytes(device) -> tuple[int, bool]:
    """(device memory in bytes, whether it was read from the device)."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1]), True
    return _HOST_DEFAULT_BYTES, False


def windows_that_fit(roi, model_cfg: BasicUNetConfig, volume_bytes: int = 0,
                     reserve_fraction: float = 0.5, device=None) -> int:
    """How many windows' activations fit beside a resident volume of
    ``volume_bytes`` in the share of device memory that ``auto_batch_size``
    budgets (below 1: not even one)."""
    total, _ = _device_bytes(device)
    dtype_bytes = 2 if model_cfg.precision == "fast" else 4
    per_window = 8 * int(np.prod(roi)) * model_cfg.features[0] * dtype_bytes
    resident = 5 * volume_bytes + min(total // 8, 2 * 2**30)
    return (int(total * (1 - reserve_fraction)) - resident) // per_window


def auto_batch_size(roi, model_cfg: BasicUNetConfig, volume_bytes: int = 0,
                    reserve_fraction: float = 0.5, device=None) -> int:
    """Window batch from device memory (the reference sizes it from free
    VRAM, inference.py:171-187). Per window about 8 live (roi·f0)-sized
    activations; resident beside them the input and the f32 accumulator and
    count map (5 × the 2 B/voxel input) and the staged-logits chunk. Rounded
    down to a power of two; capped at 256 on a card, 32 elsewhere."""
    live = _device_bytes(device)[1]
    n = min(max(1, windows_that_fit(roi, model_cfg, volume_bytes, reserve_fraction,
                                    device)), 256 if live else 32)
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def gaussian_importance_map(roi, sigma_scale: float = 0.125,
                            dtype=np.float32) -> np.ndarray:
    """MONAI ``compute_importance_map(mode='gaussian')``: a unit impulse at
    ``roi//2`` blurred by a separable Gaussian of σ = sigma_scale·roi,
    truncated at radius int(4σ+0.5), peak-normalized, then floor-clamped to
    max(min positive value, 1e-3). The floor is load-bearing: the corner
    weights underflow to f32 denormals, which flush to zero, and acc/cnt at
    single-coverage corners would be 0/0."""
    axes = []
    for n in roi:
        sigma = sigma_scale * n
        center = n // 2
        radius = int(4.0 * sigma + 0.5)
        x = np.arange(n, dtype=np.float64) - center
        g = np.exp(-0.5 * (x / sigma) ** 2)
        g[np.abs(x) > radius] = 0.0
        axes.append(g)
    m = np.einsum("i,j,k->ijk", *axes)
    m /= m.max()
    m = np.clip(m, max(float(m[m > 0].min()), 1e-3), None)
    return m.astype(dtype)


def _importance_for(cfg: SlidingWindowConfig, device):
    """Device importance map for cfg, or None in constant mode."""
    if cfg.importance == "constant":
        return None
    if cfg.importance != "gaussian":
        raise ValueError(f"unknown importance mode {cfg.importance!r}")
    imp = gaussian_importance_map(tuple(cfg.roi), cfg.importance_sigma_scale)
    return torch.from_numpy(imp).to(device)


# --------------------------------------------------------------------------
# window grid (exact reference semantics; host numpy)
# --------------------------------------------------------------------------


def scan_interval(image_size, roi_size, overlap: float) -> tuple:
    """Per-dim stride: ``roi`` if roi covers the dim, else
    ``int(roi·(1−overlap))`` min 1 (reference: sliding_window_inferer.py:255-276)."""
    out = []
    for img, roi in zip(image_size, roi_size):
        if roi == img:
            out.append(int(roi))
        else:
            interval = int(roi * (1 - overlap))
            out.append(interval if interval > 0 else 1)
    return tuple(out)


def _dim_starts(img: int, roi: int, interval: int) -> list:
    """MONAI dense_patch_slices: ceil((img−roi)/interval)+1 windows, the last
    clamped to img−roi."""
    if roi >= img:
        return [0]
    scan_num = int(math.ceil((img - roi) / interval)) + 1
    return [min(i * interval, img - roi) for i in range(scan_num)]


def dense_patch_starts(image_size, roi_size, overlap: float) -> np.ndarray:
    """All window start coordinates, shape (N, 3) int32, z-major order."""
    interval = scan_interval(image_size, roi_size, overlap)
    zs = _dim_starts(image_size[0], roi_size[0], interval[0])
    ys = _dim_starts(image_size[1], roi_size[1], interval[1])
    xs = _dim_starts(image_size[2], roi_size[2], interval[2])
    return np.array([(z, y, x) for z in zs for y in ys for x in xs], dtype=np.int32)


# --------------------------------------------------------------------------
# dense phase-sum overlap-add
#
# At overlap 0.5 every unclamped window start is i·stride with roi =
# 2·stride, so the stride-regular windows split into p³ phase groups that
# each tile their z-y-x range without overlap: one group accumulates as one
# gather + reshape + slice-add. Clamped tails take the per-window path; the
# count map of the regular windows is a closed-form constant.
# --------------------------------------------------------------------------


class _DensePlan:
    """Host-side phase decomposition of the reference window grid.

    Attributes:
      phases: list of (origin_zyx, grid_dims_MzMyMx, w_ids) — w_ids are the
        global window ids (z-major raster, as dense_patch_starts orders
        them) of the phase's slots in (mz, my, mx) raster order;
      regular_mask: (N,) bool — window is stride-regular in all dims.
    """

    def __init__(self, dims, roi, interval):
        """``dims``: the per-dim start lists of the grid being accumulated."""
        p = [roi[d] // interval[d] for d in range(3)]
        n_reg = []
        for d in range(3):
            n = len(dims[d])
            if dims[d][-1] != (n - 1) * interval[d]:
                n -= 1  # the clamped last start is irregular
            n_reg.append(n)
        self.p = tuple(p)
        n_all = tuple(len(d) for d in dims)
        reg = np.zeros(n_all, bool)
        reg[: n_reg[0], : n_reg[1], : n_reg[2]] = True
        self.regular_mask = reg.ravel()
        self.phases = []
        for gz in range(p[0]):
            for gy in range(p[1]):
                for gx in range(p[2]):
                    g = (gz, gy, gx)
                    M = tuple(
                        -(-(n_reg[d] - g[d]) // p[d]) if n_reg[d] > g[d] else 0
                        for d in range(3)
                    )
                    if 0 in M:
                        continue
                    iz = g[0] + np.arange(M[0]) * p[0]
                    iy = g[1] + np.arange(M[1]) * p[1]
                    ix = g[2] + np.arange(M[2]) * p[2]
                    w_ids = (
                        (iz[:, None, None] * n_all[1] + iy[None, :, None])
                        * n_all[2]
                        + ix[None, None, :]
                    ).ravel().astype(np.int64)
                    origin = tuple(int(g[d] * interval[d]) for d in range(3))
                    self.phases.append((origin, M, w_ids))
        self.n_windows = n_all[0] * n_all[1] * n_all[2]


def _dense_applicable(roi, interval) -> bool:
    """The phase decomposition applies when the stride divides the roi."""
    return not any(interval[d] <= 0 or roi[d] % interval[d] for d in range(3))


def _dense_plan_for(image_size, roi, interval):
    """A _DensePlan when the decomposition applies, else None."""
    if not _dense_applicable(roi, interval):
        return None
    dims = [_dim_starts(image_size[d], roi[d], interval[d]) for d in range(3)]
    return _DensePlan(dims, roi, interval)


def _window(t, start, roi):
    z, y, x = (int(v) for v in start)
    return t[z : z + roi[0], y : y + roi[1], x : x + roi[2]]


def _dense_phase_add_all(acc, src_flat, idx_list, plan: _DensePlan, roi,
                         imp=None):
    """Add every phase's windows into ``acc`` in place. ``src_flat``: (K,
    *roi) contributions; ``idx_list[i]``: (S_i,) numpy 1-based indices into
    src_flat, 0 for a slot whose window is not in this chunk."""
    rz, ry, rx = roi
    for (origin, (Mz, My, Mx), _), idx in zip(plan.phases, idx_list):
        if not idx.any():
            continue
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(acc.device)
        g = torch.where(
            (idx_t > 0)[:, None, None, None],
            src_flat[(idx_t - 1).clamp(min=0)],
            0.0,
        )
        if imp is not None:
            g = g * imp
        block = (
            g.reshape(Mz, My, Mx, rz, ry, rx)
            .permute(0, 3, 1, 4, 2, 5)
            .reshape(Mz * rz, My * ry, Mx * rx)
        )
        oz, oy, ox = origin
        acc[oz : oz + Mz * rz, oy : oy + My * ry, ox : ox + Mx * rx] += block


def _dense_count_add(cnt, plan: _DensePlan, roi, n_passes: int, imp=None):
    """Closed-form count of all regular windows: each adds 1 (or its
    importance weight) per pass over its phase's tiling."""
    rz, ry, rx = roi
    for (oz, oy, ox), (Mz, My, Mx), _ in plan.phases:
        sl = cnt[oz : oz + Mz * rz, oy : oy + My * ry, ox : ox + Mx * rx]
        if imp is None:
            sl += n_passes
        else:
            sl += (imp * n_passes).repeat(Mz, My, Mx)


def _tail_accumulate(acc, cnt, src_flat, idx, starts, roi, imp=None):
    """Per-window overlap-add of ``src_flat[idx[i]]`` at ``starts[i]``: the
    clamped-tail windows of the dense path, and every window where the dense
    decomposition does not apply."""
    for i, s in zip(idx, starts):
        c = src_flat[int(i)]
        if imp is None:
            _window(acc, s, roi).add_(c)
            _window(cnt, s, roi).add_(1)
        else:
            _window(acc, s, roi).add_(c * imp)
            _window(cnt, s, roi).add_(imp)


def _skip_accumulate(acc, cnt, starts, roi, weight: int, imp=None):
    """Background windows: constant −1000 logits and count ``weight`` (the
    number of passes) each (reference: sliding_window_inferer.py:197-202)."""
    for s in starts:
        if imp is None:
            _window(acc, s, roi).add_(SKIP_LOGIT * weight)
            _window(cnt, s, roi).add_(weight)
        else:
            _window(acc, s, roi).add_(imp * (SKIP_LOGIT * weight))
            _window(cnt, s, roi).add_(imp * weight)


def _divide(acc, cnt):
    if cnt.dtype.is_floating_point:
        # gaussian blending: weight sums are positive wherever a window lands;
        # clamping to 1 would mis-normalize edge voxels with small sums
        return acc / torch.clamp(cnt, min=1e-8)
    return acc / torch.clamp(cnt, min=1).float()


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------


def _upload_volume(volume: np.ndarray, device):
    """(Z, Y, X) volume on ``device`` and whether it holds uint16 bits.
    uint16 travels as its int16 bit pattern (2 B/voxel; PyTorch's uint16
    support is partial) and is widened window by window."""
    volume = np.require(volume, requirements=["C", "W"])  # copies a read-only map
    if volume.dtype == np.uint16:
        return torch.from_numpy(volume.view(np.int16)).to(device), True
    return torch.from_numpy(volume).to(device), False


def _values(t, u16: bool):
    """f32 intensities of a device volume slice."""
    if u16:
        return (t.to(torch.int32) & 0xFFFF).float()
    return t.float()


def _tta_passes(cfg: SlidingWindowConfig):
    """(use_noise, flip_axis) per pass: 1 base + 4×(noise, z-flip, y-flip)
    (reference: inference.py:269-279)."""
    passes = [(False, None)]
    if cfg.tta:
        for _ in range(4):
            passes += [(True, None), (True, 0), (True, 1)]
    return passes


def _forward_chunk_batches(roi, batch: int, device) -> int:
    """Window batches whose f32 logits may be staged at once between the
    forward and the overlap-add: 1/8 of device memory, at most 2 GiB."""
    total, _ = _device_bytes(device)
    per_batch = batch * int(np.prod(roi)) * 4
    return max(1, min(total // 8, 2 * 2**30) // per_batch)


def _forward_windows(model, vol, u16, starts, batch, roi, use_noise,
                     flip_axis, noise_std, gen, model_cfg, win_perm=None):
    """Gather → (noise, flip) → UNet → unflip, batch by batch; returns the
    (len(starts), *roi) f32 logits.

    ``win_perm``: the axis permutation (self-inverse) that rotated the
    volume so another axis leads; windows are rotated back to (z, y, x)
    around the UNet, which is not transposition-symmetric, and the logits
    forward again."""
    out = []
    perm = None if win_perm is None else (0, *(1 + a for a in win_perm))
    for lo in range(0, len(starts), batch):
        wins = torch.stack(
            [_values(_window(vol, s, roi), u16) for s in starts[lo : lo + batch]]
        )
        if use_noise:
            noise = torch.randn(
                wins.shape, generator=gen, device=wins.device,
                dtype=torch.float32,
            )
            wins = wins + noise * noise_std
        if perm is not None:
            wins = wins.permute(perm)
        x = wins[..., None]
        if flip_axis is not None:
            x = torch.flip(x, dims=(flip_axis + 1,))
        logits = basic_unet_apply(model, x, model_cfg)
        if flip_axis is not None:
            logits = torch.flip(logits, dims=(flip_axis + 1,))
        logits = logits[..., 0].float()
        out.append(logits if perm is None else logits.permute(perm))
    return torch.cat(out)


def _infer_dense(model, vol, u16, acc, cnt, starts, active_mask, plan, gens,
                 cfg, passes, batch, roi, model_cfg, imp, win_perm=None):
    """Accumulation with the dense phase-sum decomposition: regular windows
    through phase adds (background ones as one constant add, the count map
    in closed form), clamped tails through the per-window path. ``gens``:
    the noise generator of each pass."""
    n_passes = len(passes)
    reg = plan.regular_mask
    n_active = int(active_mask.sum())
    rank = np.full(starts.shape[0], -1, np.int64)
    rank[np.nonzero(active_mask)[0]] = np.arange(n_active)

    _dense_count_add(cnt, plan, roi, n_passes, imp)

    is_bg_reg = (~active_mask) & reg
    if is_bg_reg.any():
        sel = [is_bg_reg[w_ids].astype(np.int64) for _, _, w_ids in plan.phases]
        skip_src = torch.full(
            (1, *roi), SKIP_LOGIT * n_passes, dtype=torch.float32,
            device=acc.device,
        )
        _dense_phase_add_all(acc, skip_src, sel, plan, roi, imp)

    _skip_accumulate(acc, cnt, starts[(~active_mask) & ~reg], roi, n_passes, imp)
    if not n_active:
        return

    active = starts[active_mask]
    chunk = _forward_chunk_batches(roi, batch, acc.device) * batch
    ranks_ph = [rank[w_ids] for _, _, w_ids in plan.phases]
    tail_active = np.nonzero(active_mask & ~reg)[0]
    tail_ranks = rank[tail_active]
    chunk_plans = []
    for lo in range(0, n_active, chunk):
        hi = min(lo + chunk, n_active)
        idx_list = [np.where((r >= lo) & (r < hi), r - lo + 1, 0) for r in ranks_ph]
        tsel = (tail_ranks >= lo) & (tail_ranks < hi)
        chunk_plans.append(
            (lo, hi, idx_list, tail_ranks[tsel] - lo, starts[tail_active[tsel]])
        )

    for (use_noise, flip_axis), gen in zip(passes, gens):
        for lo, hi, idx_list, t_idx, t_starts in chunk_plans:
            flat = _forward_windows(
                model, vol, u16, active[lo:hi], batch, roi, use_noise,
                flip_axis, cfg.tta_noise_std, gen, model_cfg, win_perm,
            )
            _dense_phase_add_all(acc, flat, idx_list, plan, roi, imp)
            _tail_accumulate(acc, cnt, flat, t_idx, t_starts, roi, imp)


def _reflect_pad(volume, roi):
    """Reflect-pad dims smaller than the roi (reference:
    sliding_window_inferer.py:119-136); returns (volume, pads)."""
    pads = [(0, 0)] * 3
    for i in range(3):
        diff = max(roi[i] - volume.shape[i], 0)
        if diff:
            pads[i] = (diff // 2, diff - diff // 2)
    if any(p[0] or p[1] for p in pads):
        volume = np.pad(volume, pads, mode="reflect")
    return volume, pads


@torch.no_grad()
def infer_volume(model: BasicUNet, volume: np.ndarray,
                 cfg: SlidingWindowConfig = SlidingWindowConfig(),
                 model_cfg: BasicUNetConfig = BasicUNetConfig(),
                 return_binary: bool = True):
    """Sliding-window inference over a host (Z, Y, X) volume on the model's
    device: dense phase-sum accumulation where the stride divides the roi
    (overlap 0.5), per-window accumulation otherwise. Returns (mean_logits
    f32, binaries uint8 or None), both on that device, cropped to the input
    shape."""
    device = next(model.parameters()).device
    roi = tuple(cfg.roi)
    orig_shape = tuple(volume.shape)
    volume, pads = _reflect_pad(volume, roi)
    image_size = tuple(volume.shape)
    interval = scan_interval(image_size, roi, cfg.overlap)
    dims = [_dim_starts(image_size[d], roi[d], interval[d]) for d in range(3)]
    vol, u16 = _upload_volume(volume, device)
    batch = cfg.batch_size or auto_batch_size(
        roi, model_cfg, vol.numel() * vol.element_size(), device=device
    )
    imp = _importance_for(cfg, device)
    acc, cnt = _zero_accumulators(image_size, imp, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    _accumulate(model, vol, u16, acc, cnt, dims, interval, gen, cfg, batch,
                model_cfg, imp)

    sl = tuple(slice(pads[i][0], pads[i][0] + orig_shape[i]) for i in range(3))
    mean_logits = _divide(acc, cnt)[sl]
    binaries = None
    if return_binary:
        binaries = binarize_logits(
            mean_logits, _nonzero(vol[sl], u16), threshold=cfg.threshold,
            erosion_iters=cfg.erosion_iters,
        )
    return mean_logits, binaries


def _zero_accumulators(shape, imp, device):
    """f32 logit sums and the count map: int32 window counts, or f32 weight
    sums under gaussian importance."""
    acc = torch.zeros(shape, dtype=torch.float32, device=device)
    cnt = torch.zeros(
        shape, dtype=torch.float32 if imp is not None else torch.int32,
        device=device,
    )
    return acc, cnt


def _nonzero(t, u16: bool):
    """input > 0 of a device volume slice (uint16 bits are nonzero ⇔ > 0)."""
    return t != 0 if u16 else t > 0


def _grid_starts(dims) -> np.ndarray:
    """(N, 3) int32 window starts of the grid ``dims``, z-major."""
    return np.array(
        [(z, y, x) for z in dims[0] for y in dims[1] for x in dims[2]],
        dtype=np.int32,
    ).reshape(-1, 3)


def _active_mask(vol, u16, starts, roi, threshold) -> np.ndarray:
    """Which windows hold a voxel above ``threshold`` (the others are
    background and skip the model); one host sync."""
    maxes = torch.stack(
        [_values(_window(vol, s, roi), u16).amax() for s in starts]
    ).cpu().numpy()
    return maxes > threshold


def _accumulate(model, vol, u16, acc, cnt, dims, interval, gens, cfg, batch,
                model_cfg, imp, active_mask=None, win_perm=None):
    """Every pass of every window of the grid ``dims`` (per-dim start lists,
    local to ``vol``) into ``acc``/``cnt`` in place: background windows as
    constant skips, the rest through the model, dense phase-sum accumulation
    where the stride divides the roi and per-window accumulation otherwise.

    ``gens``: one noise generator per pass, or one generator for all passes
    in turn. ``active_mask``: the windows' background test when the caller
    made it already (``_active_mask``)."""
    roi = tuple(cfg.roi)
    starts = _grid_starts(dims)
    if active_mask is None:
        active_mask = _active_mask(vol, u16, starts, roi, cfg.background_threshold)
    passes = _tta_passes(cfg)
    if isinstance(gens, torch.Generator):
        gens = [gens] * len(passes)

    if _dense_applicable(roi, interval):
        plan = _DensePlan(dims, roi, interval)
        _infer_dense(model, vol, u16, acc, cnt, starts, active_mask, plan,
                     gens, cfg, passes, batch, roi, model_cfg, imp, win_perm)
        return
    _skip_accumulate(acc, cnt, starts[~active_mask], roi, len(passes), imp)
    active = starts[active_mask]
    chunk = _forward_chunk_batches(roi, batch, acc.device) * batch
    for (use_noise, flip_axis), gen in zip(passes, gens):
        for lo in range(0, len(active), chunk):
            flat = _forward_windows(
                model, vol, u16, active[lo : lo + chunk], batch, roi,
                use_noise, flip_axis, cfg.tta_noise_std, gen, model_cfg,
                win_perm,
            )
            _tail_accumulate(
                acc, cnt, flat, range(flat.shape[0]),
                active[lo : lo + chunk], roi, imp,
            )
