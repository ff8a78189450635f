"""Cubic B-spline free-form deformation (FFD) registration.

The port's counterpart of ``delivr_cfos_tpu/registration/bspline.py``.
Replaces mBrainAligner's ``local_registration`` binary (the FFD/LSFM stage,
reference: automate_mBrainaligner.py:60-72): a cubic B-spline control grid
over the fixed volume parameterizes a displacement field added after the
affine, optimized with Adam against masked NCC (or MI) plus a
bending-energy regularizer, in a plain autograd loop (see ``affine.py``).

The dense field is three separable basis contractions (Z×Nz · Y×Ny · X×Nx
tensor product) in full float32 (no TF32: the point and dense fields agree
to 1e-4 voxel). Point evaluation (for warping cell centroids) gathers the
4³ support control points of a batch of points at once, through one flat
index per tap, in chunks that bound the index tensors' memory.

Total transform: ``moving_coord = A @ fixed_coord + D(fixed_coord)``; both
volumes and points go through the same code path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from delivr_cfos_tpu_torch.ops.resample import block_mean_downsample
from delivr_cfos_tpu_torch.registration.affine import (
    _adam,
    sample_coords,
    similarity_fn,
    step_generator,
)
from delivr_cfos_tpu_torch.registration.warp import (
    affine_apply,
    as_points,
    fixed_grid,
    inside_weight,
    sample_volume,
)
from delivr_cfos_tpu_torch.utils.device import full_f32, resolve_device, timed, upload


def _bspline_weights(f):
    """Cubic B-spline basis at fractional offset f ∈ [0, 1); returns 4 weights."""
    f2 = f * f
    f3 = f2 * f
    return (
        (1 - f) ** 3 / 6.0,
        (3 * f3 - 6 * f2 + 4) / 6.0,
        (-3 * f3 + 3 * f2 + 3 * f + 1) / 6.0,
        f3 / 6.0,
    )


def _axis_basis(n_vox: int, n_ctrl: int, spacing: float) -> np.ndarray:
    """Dense (n_vox, n_ctrl) cubic B-spline basis matrix for one axis.
    Control point j sits at fixed coordinate (j − 1)·spacing (one-point
    margin before the volume for cubic support)."""
    B = np.zeros((n_vox, n_ctrl), np.float32)
    u = np.arange(n_vox, dtype=np.float64) / spacing
    i = np.floor(u).astype(np.int64)
    f = u - i
    w = _bspline_weights(f)
    for k in range(4):
        idx = np.clip(i + k, 0, n_ctrl - 1)
        np.add.at(B, (np.arange(n_vox), idx), w[k].astype(np.float32))
    return B


# per-call gather bound for at_points (tests shrink it to force chunking)
_POINTS_CHUNK = 131072


@dataclass
class BSplineField:
    """Displacement field over fixed space: ctrl (Nz, Ny, Nx, 3), voxels."""

    spacing: float
    fixed_shape: tuple
    ctrl: np.ndarray  # (Nz, Ny, Nx, 3) float32

    @staticmethod
    def zeros(fixed_shape, spacing: float) -> "BSplineField":
        n_ctrl = tuple(int(np.ceil(s / spacing)) + 3 for s in fixed_shape)
        return BSplineField(
            spacing=float(spacing),
            fixed_shape=tuple(fixed_shape),
            ctrl=np.zeros((*n_ctrl, 3), np.float32),
        )

    def dense_field(self, device=None) -> torch.Tensor:
        """(Z, Y, X, 3) displacement over the full fixed grid."""
        ctrl = torch.as_tensor(self.ctrl, device=resolve_device(device))
        with torch.no_grad():
            return _dense_field(ctrl, self.fixed_shape, self.spacing)

    def at_points(self, points_zyx, device=None) -> torch.Tensor:
        """Displacement at arbitrary fixed-space points (N, 3), evaluated
        in chunks of ``_POINTS_CHUNK`` points (a real hemisphere has ~1e6+
        detected cells; each point's taps take one int64 index each)."""
        dev = resolve_device(device)
        pts = as_points(points_zyx, dev)
        ctrl = torch.as_tensor(self.ctrl, device=dev)
        with torch.no_grad():
            return torch.cat([_points_field(ctrl, pts[lo:lo + _POINTS_CHUNK], self.spacing)
                              for lo in range(0, max(pts.shape[0], 1), _POINTS_CHUNK)])


def _bases(fixed_shape, ctrl_shape, spacing, device):
    """The three (n_vox, n_ctrl) basis matrices on ``device``."""
    return tuple(torch.from_numpy(_axis_basis(n, c, spacing)).to(device)
                 for n, c in zip(fixed_shape, ctrl_shape[:3]))


def _dense_field(ctrl, fixed_shape, spacing, bases=None):
    """(Z, Y, X, 3) field of ``ctrl`` (Nz, Ny, Nx, 3): the JAX package's
    three tensordots in its order, in full float32 (``precision="highest"``
    there). ``bases`` are ``_bases(...)``, passed by a caller that reuses
    them."""
    Bz, By, Bx = bases or _bases(fixed_shape, ctrl.shape, spacing, ctrl.device)
    with full_f32():
        t = torch.tensordot(Bz, ctrl, dims=([1], [0]))  # (Z, Ny, Nx, 3)
        t = torch.tensordot(By, t, dims=([1], [1]))  # (Y, Z, Nx, 3)
        t = torch.tensordot(Bx, t, dims=([1], [2]))  # (X, Y, Z, 3)
    return t.permute(2, 1, 0, 3)


def _points_field(ctrl, points, spacing):
    """Displacement (N, 3) at ``points`` (N, 3): the 4³ support taps of
    every point in one gather through a flat index, weighted by the tensor
    product of the three axes' cubic weights, summed over the taps."""
    nz, ny, nx, _ = ctrl.shape
    u = points / spacing
    i = torch.floor(u.detach())
    f = u - i
    i = i.long()
    taps = torch.arange(4, device=points.device)

    def axis(k, n):
        w = torch.stack(_bspline_weights(f[:, k]), dim=1)  # (N, 4)
        idx = (i[:, k:k + 1] + taps).clamp_(0, n - 1)  # (N, 4)
        return w, idx

    wz, iz = axis(0, nz)
    wy, iy = axis(1, ny)
    wx, ix = axis(2, nx)
    flat = ((iz[:, :, None, None] * ny + iy[:, None, :, None]) * nx
            + ix[:, None, None, :])  # (N, 4, 4, 4)
    sub = ctrl.reshape(-1, 3)[flat]  # (N, 4, 4, 4, 3)
    w = wz[:, :, None, None] * wy[:, None, :, None] * wx[:, None, None, :]
    return torch.sum(sub * w[..., None], dim=(1, 2, 3))


def _bending_energy(ctrl):
    """Squared second differences of the control grid (thin-plate proxy)."""
    e = 0.0
    for ax in range(3):
        d2 = torch.diff(ctrl, n=2, dim=ax)
        e = e + torch.mean(d2 * d2)
    return e


def _optimize_ffd(fixed, moving, affine, ctrl0, fixed_shape, spacing, lr, lam,
                  n_steps, similarity="ncc", n_samples=0, seed=0, level_index=0):
    """``n_steps`` Adam steps on the control grid at one level. Returns the
    control grid and the loss of the last step (before its update), the
    bending term included."""
    sim = similarity_fn(similarity)
    ctrl = ctrl0.detach().clone().requires_grad_(True)
    opt = _adam(ctrl, lr)
    last = None
    with full_f32():
        if not n_samples:
            base = affine_apply(affine, fixed_grid(fixed_shape, fixed.device))
            bases = _bases(fixed_shape, ctrl.shape, spacing, fixed.device)
        for step in range(n_steps):
            if n_samples:
                # stochastic similarity (see affine.py::_optimize_level): a
                # fresh coordinate subset per step, displacements from the
                # 64-tap point gather instead of the dense field
                coords_f = sample_coords(step_generator(seed, level_index, step),
                                         fixed_shape, n_samples, fixed.device)
                fixed_vals = sample_volume(fixed, coords_f)
                coords = affine_apply(affine, coords_f) + _points_field(
                    ctrl, coords_f, spacing)
            else:
                fixed_vals = fixed
                coords = base + _dense_field(ctrl, fixed_shape, spacing, bases)
            warped = sample_volume(moving, coords)
            w = inside_weight(coords, moving.shape)
            loss = -sim(warped, fixed_vals, w) + lam * _bending_energy(ctrl)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            last = loss.detach()
    return ctrl.detach(), last


def register_bspline(
    fixed: np.ndarray,
    moving: np.ndarray,
    affine: np.ndarray,
    spacing: float = 16.0,
    iters: int = 150,
    lr: float = 0.3,
    bending_weight: float = 1e-3,
    verbose: bool = False,
    similarity: str = "ncc",
    levels=(1,),
    n_samples: int = 0,
    seed: int = 0,
    device=None,
    timer=None,
):
    """Returns (BSplineField, final NCC). ``affine`` is the fixed→moving
    matrix from ``register_affine``; the FFD refines on top of it.

    ``levels`` is a coarse→fine downsample-factor schedule. The control grid
    keeps the SAME topology across levels: at factor f the level grid uses
    spacing/f in level voxels, so control point j sits at level coordinate
    (j−1)·spacing/f ↔ full-res (j−1)·spacing — identical knots — and level
    displacements map to full-res by ×f. ``iters``/``lr`` may be per-level
    tuples. The default ``(1,)`` is the single-resolution path.

    ``n_samples > 0``: stochastic similarity over that many jittered-lattice
    coordinates per gradient step (see ``register_affine``); the returned
    score is then a dense evaluation. 0 = dense (default): the score is the
    negated loss of the last step, bending term included. The volumes go to
    ``device`` (None: the card); ``timer`` gets one step "ffd_level{level}"
    per level.
    """
    dev = resolve_device(device)
    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)
    n_levels = len(levels)
    iters_t = (iters,) * n_levels if np.isscalar(iters) else tuple(iters)
    lrs_t = (lr,) * n_levels if np.isscalar(lr) else tuple(lr)
    if not (len(iters_t) == len(lrs_t) == n_levels):
        raise ValueError("levels/iters/lr schedules disagree in length")
    field = BSplineField.zeros(fixed.shape, spacing)
    affine = np.asarray(affine, np.float32)
    ctrl = torch.from_numpy(field.ctrl).to(dev)  # full-resolution voxel units
    fixed_t = upload(fixed, dev)
    moving_t = upload(moving, dev)
    last_loss = 0.0
    for li, (level, level_iters, level_lr) in enumerate(zip(levels, iters_t, lrs_t)):
        level = int(level)
        with timed(timer, f"ffd_level{level}"):
            affine_l = affine.copy()
            if level == 1:
                fixed_l, moving_l = fixed_t, moving_t
            else:
                fac = (level, level, level)
                fixed_l = block_mean_downsample(fixed_t, fac)
                moving_l = block_mean_downsample(moving_t, fac)
                # S⁻¹ A S: linear part is scale-invariant, translation ÷ f
                affine_l[:, 3] = affine[:, 3] / level
            affine_j = torch.from_numpy(affine_l).to(dev)
            # small levels keep dense gradients (see register_affine's 64× bar)
            ns = n_samples if (n_samples and fixed_l.numel() > 64 * n_samples) else 0
            ctrl_l, last = _optimize_ffd(
                fixed_l, moving_l, affine_j, ctrl / level, tuple(fixed_l.shape),
                float(spacing) / level, level_lr, bending_weight, level_iters,
                similarity=similarity, n_samples=ns, seed=seed, level_index=li,
            )
            last_loss = float(last)
            ctrl = ctrl_l * level
            if ns:
                last_loss = -float(_ffd_dense_score(
                    fixed_l, moving_l, affine_j, ctrl_l, tuple(fixed_l.shape),
                    float(spacing) / level, similarity))
        if verbose:
            print(f"[ffd] level {level}: {level_iters} steps, loss {last_loss:.4f}")
    field.ctrl = ctrl.cpu().numpy()
    return field, -last_loss


@torch.no_grad()
def _ffd_dense_score(fixed, moving, affine, ctrl, fixed_shape, spacing,
                     similarity="ncc"):
    """Dense similarity of affine+FFD — reported by the stochastic path so
    scores stay comparable to the dense optimizer's."""
    with full_f32():
        grid = fixed_grid(fixed_shape, fixed.device)
        coords = affine_apply(affine, grid) + _dense_field(ctrl, fixed_shape, spacing)
        warped = sample_volume(moving, coords)
        w = inside_weight(coords, moving.shape)
        return similarity_fn(similarity)(warped, fixed, w)


def warp_points(affine: np.ndarray, field: BSplineField | None, points_zyx,
                device=None) -> np.ndarray:
    """Fixed-space points → moving space through affine (+ optional FFD),
    in float32 on ``device`` (None: the card); returns a host array."""
    dev = resolve_device(device)
    pts = as_points(points_zyx, dev)
    with torch.no_grad(), full_f32():
        out = affine_apply(torch.as_tensor(np.asarray(affine, np.float32), device=dev), pts)
        if field is not None:
            out = out + field.at_points(pts, device=dev)
    return out.cpu().numpy()
