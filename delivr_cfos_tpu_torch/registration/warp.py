"""Volume warping primitives: trilinear sampling and affine coordinate maps.

The port's counterpart of ``delivr_cfos_tpu/registration/warp.py``, in plain
torch on the device of its inputs. These replace mBrainAligner's C++
resamplers (reference: automate_mBrainaligner.py:21-72 shells out to
``global_registration``/``local_registration`` binaries). Coordinates are
(z, y, x) voxel indices; an affine is a (3, 4) matrix ``A`` mapping fixed
voxel coords to moving voxel coords: ``m = A[:, :3] @ f + A[:, 3]``.

The JAX package cuts its optimizers' scans into segments sized by a voxel
budget (``scan_chunk_for``) so that no compiled TPU program runs past the
worker's time limit; its step sequence is the same whatever the cut. An
eager autograd loop has no such limit, so the port has no segmentation.
"""

from __future__ import annotations

import numpy as np
import torch

from delivr_cfos_tpu_torch.utils.device import resolve_device


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi). At a tie with a bound the gradient
    is split evenly, as JAX's is; ``torch.clamp`` passes all of it. The
    bounds are filled on the device (no host-to-device copy, which would
    wait for the queue)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def sample_volume(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample ``volume`` (Z, Y, X) at ``coords`` (..., 3) (z, y, x).
    Out-of-bounds reads clamp to the edge; a validity weight is NOT applied
    here (callers mask explicitly when needed).

    Each corner is one gather through a flat int64 index. The corner
    indices carry no gradient (``floor`` has none in either package), so
    they are computed without autograd."""
    Z, Y, X = volume.shape
    flat = volume.reshape(-1)
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    with torch.no_grad():
        z0 = torch.floor(z).clamp_(0, Z - 1)
        y0 = torch.floor(y).clamp_(0, Y - 1)
        x0 = torch.floor(x).clamp_(0, X - 1)
        z0i, y0i, x0i = z0.long(), y0.long(), x0.long()
        # the +1 neighbour's flat offset, 0 at the last plane, row or column
        dz = (z0i < Z - 1).long() * (Y * X)
        dy = (y0i < Y - 1).long() * X
        dx = (x0i < X - 1).long()
        i000 = (z0i * Y + y0i) * X + x0i
        del z0i, y0i, x0i
    wz = clip(z - z0, 0.0, 1.0)
    wy = clip(y - y0, 0.0, 1.0)
    wx = clip(x - x0, 0.0, 1.0)
    del z0, y0, x0

    ux, uy = 1 - wx, 1 - wy

    def plane(i):  # bilinear in the z plane whose (y0, x0) corner is at i
        c00 = flat[i] * ux + flat[i + dx] * wx
        c01 = flat[i + dy] * ux + flat[i + dy + dx] * wx
        return c00 * uy + c01 * wy

    c0 = plane(i000)
    c1 = plane(i000 + dz)
    return c0 * (1 - wz) + c1 * wz


def inside_weight(coords: torch.Tensor, shape) -> torch.Tensor:
    """1.0 where coords fall inside the volume, 0.0 outside (soft mask for
    similarity losses so out-of-FOV regions don't dominate)."""
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    ok = (
        (z >= 0)
        & (z <= shape[0] - 1)
        & (y >= 0)
        & (y <= shape[1] - 1)
        & (x >= 0)
        & (x <= shape[2] - 1)
    )
    return ok.to(torch.float32)


def fixed_grid(shape, device) -> torch.Tensor:
    """Dense (Z, Y, X, 3) grid of fixed voxel coordinates."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def affine_apply(affine: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Apply (3, 4) affine to (..., 3) coords."""
    return coords @ affine[:, :3].T + affine[:, 3]


def warp_volume_affine(moving: torch.Tensor, affine: torch.Tensor, fixed_shape) -> torch.Tensor:
    """Resample ``moving`` onto the fixed grid through the affine."""
    grid = fixed_grid(fixed_shape, moving.device)
    coords = affine_apply(affine.to(moving.device, torch.float32), grid)
    return sample_volume(moving.float(), coords)


def as_points(points, device) -> torch.Tensor:
    """(N, 3) float32 points on ``device``, from a host array or a tensor."""
    if torch.is_tensor(points):
        return points.to(device, torch.float32)
    return torch.as_tensor(np.asarray(points, np.float32), device=device)


def affine_warp_points(affine, points_zyx, device=None) -> torch.Tensor:
    """Map fixed-space points (N, 3) (z, y, x) into moving space."""
    dev = resolve_device(device)
    return affine_apply(torch.as_tensor(np.asarray(affine, np.float32), device=dev),
                        as_points(points_zyx, dev))


def identity_affine() -> np.ndarray:
    return np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1).astype(np.float32)


def moments_init(fixed: np.ndarray, moving: np.ndarray) -> np.ndarray:
    """Initial affine from intensity first/second moments: per-axis scale and
    translation aligning the mass centroids and spreads. Robust starting
    point for multi-resolution refinement. On the host in float64, as the
    JAX package computes it."""
    def stats(v):
        v = np.asarray(v, np.float64)
        w = v / max(v.sum(), 1e-9)
        grids = np.indices(v.shape).astype(np.float64)
        mean = np.array([(g * w).sum() for g in grids])
        var = np.array([((g - m) ** 2 * w).sum() for g, m in zip(grids, mean)])
        return mean, np.sqrt(np.maximum(var, 1e-9))

    mf, sf = stats(fixed)
    mm, sm = stats(moving)
    scale = sm / sf
    A = np.diag(scale)
    t = mm - A @ mf
    return np.concatenate([A, t[:, None]], axis=1).astype(np.float32)
