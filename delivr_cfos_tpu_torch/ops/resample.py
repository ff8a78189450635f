"""Volume resampling ops: anisotropic block-mean downsample, trilinear zoom,
and the reference's 8-bit contrast stretch, as torch ops on the device of
their input (or the ``device`` a host array is uploaded to).

The port's counterpart of ``delivr_cfos_tpu/ops/resample.py``. These replace
stage 1's CPU machinery (reference: downsample/downsample_and_mask.py): the
``mp.Pool`` of ``skimage.transform.downscale_local_mean`` calls (:184-192),
the single-threaded ``scipy.ndimage.zoom`` mask upsample (:296-315), and
``histogram_equalization_8b`` (:118-136).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.utils.device import resolve_device


def block_mean_downsample(volume: torch.Tensor, factors: tuple) -> torch.Tensor:
    """``skimage.transform.downscale_local_mean(volume, factors)`` semantics:
    zero-pad each dim up to a multiple of the factor, then block-average
    (padded zeros are included in the mean, as in skimage), returning float32.

    Integer volumes sum exactly in int64 and round once to float32 before the
    division, so the result does not depend on the order of the sum. The JAX
    package sums in float32: where every partial sum stays below 2^24 the two
    agree bit for bit; above it (blocks of 900 voxels near the top of the
    uint16 range) the JAX sum rounds in its own order, and the callers'
    truncation to uint16 may differ by one count. The mean is the sum times
    the float32 reciprocal of the block size, as XLA computes it. The reference truncates to
    uint16 afterwards (downsample_and_mask.py:44); callers do that cast.
    """
    pads = []
    for i in reversed(range(volume.ndim)):
        pads += [0, (-volume.shape[i]) % factors[i]]
    if any(pads):
        volume = F.pad(volume, pads)
    shape = []
    for n, f in zip(volume.shape, factors):
        shape += [n // f, f]
    blocks = volume.reshape(shape)
    dims = tuple(range(1, 2 * volume.ndim, 2))
    if volume.dtype.is_floating_point:
        summed = blocks.float().sum(dim=dims)
    else:
        summed = blocks.sum(dim=dims, dtype=torch.int64).float()
    return summed * reciprocal_f32(np.prod(factors))


def reciprocal_f32(n) -> float:
    """``1/n`` rounded to float32. XLA turns a division by a constant into a
    multiplication by its float32 reciprocal, so this is what the JAX
    package computes for ``x / n``; a true division differs in the last bit
    for most ``n`` that are not powers of two."""
    return float(np.float32(1) / np.float32(n))


def _resize_axis(arr: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = arr.shape[axis]
    if n_out == n_in:
        return arr
    scale = float(np.float32((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0))
    coords = torch.arange(n_out, dtype=torch.float32, device=arr.device) * scale
    coords = torch.clamp(coords, 0.0, n_in - 1)
    lo = torch.floor(coords).long()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    w = coords - lo.float()
    a = arr.index_select(axis, lo)
    b = arr.index_select(axis, hi)
    shape = [1] * arr.ndim
    shape[axis] = n_out
    w = w.reshape(shape)
    return a * (1.0 - w) + b * w


def trilinear_zoom(volume: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """Trilinear resize with scipy ``zoom(..., order=1, grid_mode=False)``
    coordinate convention: output index i maps to input coordinate
    ``i · (in−1)/(out−1)`` (endpoints aligned), as float32 ``arange · scale``
    with the scale rounded to float32 first, as JAX's weak typing does.
    Returns float32; the blend keeps the reference expression
    ``a·(1−w) + b·w``, one rounding per operation."""
    x = volume.float()
    for ax in range(3):
        x = _resize_axis(x, ax, out_shape[ax])
    return x


def zoom_mask_to(
    mask: np.ndarray, out_shape: tuple, chunk_z: int = 64, out=None, *, device=None
) -> np.ndarray:
    """Upsample a small binary (z, y, x) mask to ``out_shape`` in z-chunks on
    ``device`` (None: the card); returns uint8 with scipy-style truncation toward zero (the
    reference zooms into a uint8 memmap, downsample_and_mask.py:296-299).

    Chunking maps each output z-slab to the input z-range it interpolates
    from, so the device holds one output slab. Pass a disk memmap as ``out``
    for full-resolution masks (a hemisphere-scale mask does not fit in RAM —
    the reference's mask_us memmap discipline).
    """
    device = resolve_device(device)
    zi, yi, xi = mask.shape
    zo, yo, xo = out_shape
    if out is None:
        out = np.empty(out_shape, np.uint8)
    if out.shape != tuple(out_shape):
        raise ValueError(f"out has shape {out.shape}, not {tuple(out_shape)}")
    mask_f = mask.astype(np.float32)
    z_scale = (zi - 1) / (zo - 1) if zo > 1 else 0.0
    for z0 in range(0, zo, chunk_z):
        z1 = min(z0 + chunk_z, zo)
        # input coordinate range needed for this output slab
        src0 = int(np.floor(z0 * z_scale))
        src1 = min(int(np.floor(max(z1 - 1, 0) * z_scale)) + 2, zi)
        sub = torch.from_numpy(mask_f[src0:src1]).to(device)
        res = _zoom_slab(sub, (z1 - z0, yo, xo), z0, z_scale, src0, zi)
        out[z0:z1] = res.to(torch.uint8).cpu().numpy()
    return out


def _zoom_slab(sub, out_shape, z0, z_scale, src0, zi):
    n_out_z, yo, xo = out_shape
    z_scale = float(np.float32(z_scale))  # JAX passes it as a weak float32
    coords = (torch.arange(n_out_z, dtype=torch.float32, device=sub.device) + z0) * z_scale
    coords = torch.clamp(coords, 0.0, zi - 1) - src0
    lo = torch.floor(coords).long()
    hi = torch.clamp(lo + 1, max=sub.shape[0] - 1)
    w = (coords - lo.float())[:, None, None]
    a = sub.index_select(0, lo)
    b = sub.index_select(0, hi)
    slab = a * (1.0 - w) + b * w
    return trilinear_zoom(slab, (n_out_z, yo, xo))


def _percentile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(flat, q)`` (method 'linear') in float32, by
    ``kthvalue``: ``torch.quantile`` refuses more than 2^24 elements, and a
    downsampled brain holds 60 M voxels."""
    qf = torch.tensor(q, dtype=torch.float32) / 100.0
    n = torch.tensor(flat.numel(), dtype=torch.float32)
    pos = qf * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    last = flat.numel() - 1
    lo_i = min(max(int(low), 0), last)
    hi_i = min(max(int(high), 0), last)
    low_v = torch.kthvalue(flat, lo_i + 1).values
    high_v = torch.kthvalue(flat, hi_i + 1).values
    return low_v * low_w.to(flat.device) + high_v * high_w.to(flat.device)


def contrast_stretch_8bit(stack: torch.Tensor) -> torch.Tensor:
    """The reference's ``histogram_equalization_8b``
    (downsample_and_mask.py:118-136): clip to the [1%, 99%] percentiles
    (rounded), stretch to 0..65534 uint16, then skimage ``img_as_ubyte``
    (a >>8 bit shift for uint16 → uint8). Stage 1 itself uses the host
    version with its in-place clip (``_equalize_8bit_inplace``).
    """
    x = stack.float()
    flat = x.reshape(-1)
    minval = torch.round(_percentile(flat, 1))
    maxval = torch.round(_percentile(flat, 99))
    x = torch.clamp(x, minval, maxval)
    eq16 = ((x - minval) / (maxval - minval) * 65534.0).to(torch.int32)
    return (eq16 >> 8).to(torch.uint8)
