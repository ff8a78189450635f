"""Registration acceptance harness (VERDICT r1 item 5; SURVEY.md §7 calls
registration "the hardest correctness risk in the project").

The reference validates registration against published per-stage demo
intermediates (reference README.md:40-41) — not available offline — so the
framework carries its own acceptance protocol: synthesize a labeled
atlas-like volume, deform it through a KNOWN ground-truth transform,
register back, and score

- **point-warp error**: |T_est(p) − T_true(p)| over brain-interior points;
- **per-region count F1**: cells assigned to regions through T_est vs
  T_true — the metric that actually decides whether downstream region
  tables are right (SURVEY.md §7 step 6 acceptance criterion).

This is the port's counterpart of ``delivr_cfos_tpu/registration/validate.py``:
the synthetic atlas, the degradation and the metrics are its numpy copies;
resampling and the transforms run in torch on a device. A transform function
takes (N, 3) fixed-space points (a host array or a tensor) and returns a
tensor of moving-space points on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from delivr_cfos_tpu_torch.registration.warp import (
    affine_apply,
    as_points,
    fixed_grid,
    sample_volume,
)
from delivr_cfos_tpu_torch.utils.device import full_f32, resolve_device


def make_synthetic_atlas(
    shape=(64, 48, 72), n_regions: int = 12, seed: int = 0
):
    """Brain-like moving volume: an ellipsoidal "brain" of Voronoi regions
    with distinct intensities plus smooth shading. Returns
    (volume float32, labels int32) — labels 0 = outside."""
    rng = np.random.default_rng(seed)
    Z, Y, X = shape
    zz, yy, xx = np.meshgrid(
        np.arange(Z), np.arange(Y), np.arange(X), indexing="ij"
    )
    c = np.array([Z / 2, Y / 2, X / 2])
    r = np.array([Z / 2.2, Y / 2.2, X / 2.2])
    inside = (
        ((zz - c[0]) / r[0]) ** 2
        + ((yy - c[1]) / r[1]) ** 2
        + ((xx - c[2]) / r[2]) ** 2
    ) <= 1.0

    seeds = np.stack(
        [
            rng.uniform(0.15 * Z, 0.85 * Z, n_regions),
            rng.uniform(0.15 * Y, 0.85 * Y, n_regions),
            rng.uniform(0.15 * X, 0.85 * X, n_regions),
        ],
        axis=1,
    )
    pts = np.stack([zz, yy, xx], axis=-1).astype(np.float32)
    d = np.linalg.norm(
        pts[None] - seeds[:, None, None, None, :].astype(np.float32), axis=-1
    )
    labels = (np.argmin(d, axis=0) + 1).astype(np.int32)
    labels[~inside] = 0

    intensities = rng.uniform(80, 255, n_regions + 1).astype(np.float32)
    intensities[0] = 0.0
    vol = intensities[labels]
    # smooth shading so NCC has gradients inside regions
    shade = (
        40 * np.sin(2 * np.pi * zz / Z)
        + 30 * np.cos(2 * np.pi * yy / Y)
        + 20 * np.sin(2 * np.pi * xx / X)
    )
    vol = np.clip(vol + shade * inside, 0, 400).astype(np.float32)
    return vol, labels


def lsfm_degrade(
    vol: np.ndarray,
    seed: int = 0,
    gamma: float = 0.55,
    blur_sigma=(2.2, 0.8, 0.8),
    noise_std: float = 6.0,
    stripe_amp: float = 0.12,
    fov_crop_z: float = 0.18,
):
    """Make a clean synthetic acquisition LSFM-realistic (VERDICT r2 item 6):

    - **nonlinear monotone intensity map** (gamma + soft saturation): the
      relation between an autofluorescence acquisition and the atlas average
      template is not linear, so NCC's linear model is dishonest on clean
      Voronoi phantoms — after this remap only MI-class similarities are
      expected to keep working;
    - **anisotropic blur** (light-sheet z-smear ≫ lateral);
    - **multiplicative stripe artifact** along x (shadowing);
    - **additive noise**;
    - **partial FOV**: the top ``fov_crop_z`` fraction of z is zeroed, the
      acquisition cut off mid-brain as hemisphere scans are.

    Returns the degraded float32 volume (same shape).
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(vol, np.float32)
    peak = max(float(x.max()), 1.0)
    # monotone nonlinearity: normalized gamma + soft shoulder
    xn = np.clip(x / peak, 0, 1)
    y = xn**gamma
    y = y / (0.6 + 0.4 * y)  # saturating shoulder
    y *= 255.0
    # separable gaussian blur (anisotropic, z-heavy)
    from scipy.ndimage import gaussian_filter

    y = gaussian_filter(y, sigma=blur_sigma)
    # stripes: smooth multiplicative modulation along x
    xs = np.arange(x.shape[2])
    stripes = 1.0 + stripe_amp * np.sin(2 * np.pi * xs / 23.0 + rng.uniform(0, 6))
    y = y * stripes[None, None, :]
    y = y + rng.normal(0.0, noise_std, y.shape)
    y = np.clip(y, 0, 300).astype(np.float32)
    if fov_crop_z > 0:
        y[: int(x.shape[0] * fov_crop_z)] = 0.0
    return y


def apply_transform_volume(moving: np.ndarray, fixed_shape, transform_fn, device=None):
    """Pull-back resample: fixed[v] = moving[transform_fn(v)], on ``device``
    (None: the card). ``transform_fn`` takes/returns (N, 3) points."""
    dev = resolve_device(device)
    with torch.no_grad(), full_f32():
        grid = fixed_grid(tuple(fixed_shape), dev)
        coords = transform_fn(grid.reshape(-1, 3)).reshape(grid.shape)
        del grid
        vol = torch.as_tensor(np.asarray(moving, np.float32), device=dev)
        return sample_volume(vol, coords).cpu().numpy()


def sample_brain_points(labels_fixed: np.ndarray, n: int, seed: int = 0):
    """Random fixed-space points inside the brain (label > 0)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.nonzero(labels_fixed > 0)
    idx = rng.choice(zz.shape[0], size=min(n, zz.shape[0]), replace=False)
    pts = np.stack([zz[idx], yy[idx], xx[idx]], axis=1).astype(np.float32)
    return pts + rng.uniform(-0.4, 0.4, pts.shape).astype(np.float32)


def lookup_regions(labels_moving: np.ndarray, coords_zyx: np.ndarray):
    """Nearest-voxel region id per moving-space coordinate (0 outside)."""
    c = np.rint(np.asarray(coords_zyx)).astype(np.int64)
    out = np.zeros(c.shape[0], np.int32)
    ok = np.all((c >= 0) & (c < np.asarray(labels_moving.shape)), axis=1)
    out[ok] = labels_moving[c[ok, 0], c[ok, 1], c[ok, 2]]
    return out


def region_count_f1(true_regions: np.ndarray, est_regions: np.ndarray) -> float:
    """Micro-F1 over per-region cell counts (the region-table metric):
    per region, overlap = min(count_true, count_est);
    F1 = 2·Σ overlap / (Σ count_true + Σ count_est) over regions > 0."""
    ids = np.union1d(np.unique(true_regions), np.unique(est_regions))
    ids = ids[ids > 0]
    tp = 0
    n_true = int((true_regions > 0).sum())
    n_est = int((est_regions > 0).sum())
    for r in ids:
        tp += min(int((true_regions == r).sum()), int((est_regions == r).sum()))
    denom = n_true + n_est
    return 2.0 * tp / denom if denom else 1.0


def acceptance_metrics(
    transform_est_fn,
    transform_true_fn,
    points_fixed: np.ndarray,
    labels_moving: np.ndarray,
) -> dict:
    """Score an estimated fixed→moving transform against ground truth."""
    est = transform_est_fn(points_fixed).cpu().numpy()
    true = transform_true_fn(points_fixed).cpu().numpy()
    err = np.linalg.norm(est - true, axis=1)
    true_regions = lookup_regions(labels_moving, true)
    est_regions = lookup_regions(labels_moving, est)
    return {
        "point_error_mean": float(err.mean()),
        "point_error_p95": float(np.percentile(err, 95)),
        "region_count_f1": region_count_f1(true_regions, est_regions),
        "cell_region_accuracy": float((true_regions == est_regions).mean()),
    }


def affine_transform_fn(affine: np.ndarray, device=None):
    return affine_ffd_transform_fn(affine, None, device)


def affine_ffd_transform_fn(affine: np.ndarray, field, device=None):
    dev = resolve_device(device)
    aff = torch.as_tensor(np.asarray(affine, np.float32), device=dev)

    def fn(pts):
        pts = as_points(pts, dev)
        with torch.no_grad(), full_f32():
            out = affine_apply(aff, pts)
            if field is not None:
                out = out + field.at_points(pts, device=dev)
        return out

    return fn
