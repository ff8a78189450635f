"""Multi-resolution affine registration as an autograd optimization.

The port's counterpart of ``delivr_cfos_tpu/registration/affine.py``.
Replaces mBrainAligner's ``global_registration`` binary (reference:
automate_mBrainaligner.py:29-56, invoked with ``-p r+f+n``). Instead of the
reference's feature/RANSAC pipeline the 12 affine parameters are optimized
directly with Adam against a masked NCC (or MI) similarity on an image
pyramid. Where the JAX package runs each level as one compiled ``lax.scan``
of ``value_and_grad`` + ``optax.adam`` steps, the port runs a plain loop on
the device: loss, ``backward``, ``torch.optim.Adam`` step (optax's defaults:
betas (0.9, 0.999), eps 1e-8). The two agree to a tolerance, not to the
bit: Adam's update rounds in another order.

Convention: the affine maps **fixed** voxel coords → **moving** voxel coords
(the resampling direction). For the pipeline, fixed = the downsampled masked
brain and moving = the atlas template, so cell centroids (which live in brain
space) map directly through the affine into atlas space — no numerical
inversion is ever needed.
"""

from __future__ import annotations

import numpy as np
import torch

from delivr_cfos_tpu_torch.ops.resample import block_mean_downsample
from delivr_cfos_tpu_torch.registration.warp import (
    affine_apply,
    fixed_grid,
    inside_weight,
    moments_init,
    sample_volume,
)
from delivr_cfos_tpu_torch.utils.device import full_f32, resolve_device, timed, upload


def masked_ncc(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted normalized cross-correlation (higher = better)."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    ma = torch.sum(a * w) / wsum
    mb = torch.sum(b * w) / wsum
    da = (a - ma) * w
    db = (b - mb) * w
    num = torch.sum(da * db)
    den = torch.sqrt(torch.sum(da * da) * torch.sum(db * db)) + 1e-6
    return num / den


def masked_mi(
    a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, n_bins: int = 32
) -> torch.Tensor:
    """Differentiable mutual information via soft (Parzen/linear) binning
    (higher = better). NCC only models LINEAR intensity relationships;
    brain-autofluorescence ↔ atlas-average-template alignment is
    cross-modality-ish, which is why mBrainAligner's global stage offers
    feature/landmark modes. Soft-histogram MI handles any intensity
    mapping and stays end-to-end differentiable for the Adam optimizer.

    The joint histogram is four accumulating ``index_put`` calls, one per
    corner of each sample's 2×2 bin patch, in the JAX package's order. On
    CUDA an accumulating ``index_put`` sorts its indices and sums each bin's
    run in that order, with no atomics, so a run repeats bit for bit.
    """
    wf = w.reshape(-1)
    wsum = torch.clamp(torch.sum(wf), min=1e-6)

    def bin_coords(x):
        x = x.reshape(-1)
        lo = torch.min(x)
        hi = torch.max(x)
        u = (x - lo) / torch.maximum(hi - lo, hi.new_full((), 1e-6)) * (n_bins - 1)
        i = torch.floor(u.detach()).to(torch.int64).clamp_(0, n_bins - 2)
        f = u - i.to(torch.float32)
        return i, f

    ia, fa = bin_coords(a)
    ib, fb = bin_coords(b)
    # partial-volume joint histogram: each sample splits bilinearly over a
    # 2×2 bin patch (gradients flow through the fractional weights)
    joint = torch.zeros(n_bins * n_bins, dtype=torch.float32, device=a.device)
    for da, wa in ((0, 1.0 - fa), (1, fa)):
        for db, wb in ((0, 1.0 - fb), (1, fb)):
            joint = joint.index_put(
                ((ia + da) * n_bins + (ib + db),), wa * wb * wf, accumulate=True
            )
    joint = joint.reshape(n_bins, n_bins) / wsum
    pa_m = torch.sum(joint, dim=1)
    pb_m = torch.sum(joint, dim=0)
    eps = 1e-10
    return torch.sum(
        joint * (torch.log(joint + eps) - torch.log(pa_m[:, None] * pb_m[None, :] + eps))
    )


def similarity_fn(name: str):
    """'ncc' (linear intensity relation) or 'mi' (any relation)."""
    if name == "mi":
        return masked_mi
    if name == "ncc":
        return masked_ncc
    raise ValueError(f"unknown similarity {name!r} (use 'ncc' or 'mi')")


def step_generator(seed: int, level_index: int, step: int) -> torch.Generator:
    """The host generator of one optimizer step's draw, seeded from (seed,
    level index, step). The JAX package folds the same three into a
    ``jax.random`` key; the draws differ between the packages, and agree
    between the port's card and CPU runs (they are drawn on the host)."""
    state = np.random.SeedSequence([seed, level_index, step]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def sample_coords(gen: torch.Generator, shape, n_samples: int, device) -> torch.Tensor:
    """(~n_samples, 3) continuous fixed-space coordinates: a jittered
    lattice (stratified sampling — each of ~n_samples volume cells
    contributes exactly one uniform point per step). Off-grid like
    elastix's random-coordinate sampler, but with far lower estimator
    variance for spatially-local parameters: a B-spline control point's
    support always receives its share of samples.

    The lattice is numpy; the jitter is drawn from ``gen`` on the host and
    moved to ``device``."""
    dims = np.asarray(shape, np.float64)
    scale = (n_samples / dims.prod()) ** (1.0 / 3.0)
    counts = np.maximum(1, np.round(dims * scale).astype(int))
    grids = np.meshgrid(*[np.arange(c) for c in counts], indexing="ij")
    base = torch.from_numpy(np.stack(grids, axis=-1).reshape(-1, 3).astype(np.float32))
    pitch = torch.from_numpy((dims / counts).astype(np.float32))
    u = torch.rand(base.shape, generator=gen, dtype=torch.float32)
    top = torch.from_numpy((dims - 1.0).astype(np.float32))
    return torch.minimum((base + u) * pitch, top).to(device)


def _adam(param: torch.Tensor, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s defaults (betas (0.9, 0.999), eps 1e-8)."""
    return torch.optim.Adam([param], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _optimize_level(fixed, moving, affine0, lr, n_steps, similarity="ncc",
                    n_samples=0, seed=0, level_index=0):
    """``n_steps`` Adam steps on the affine at one pyramid level. Returns the
    affine and the loss of the last step (computed before its update)."""
    sim = similarity_fn(similarity)
    affine = affine0.detach().clone().requires_grad_(True)
    opt = _adam(affine, lr)
    grid = None if n_samples else fixed_grid(fixed.shape, fixed.device)
    last = None
    with full_f32():
        for step in range(n_steps):
            if n_samples:
                # stochastic similarity (elastix-style random coordinate
                # subset, fresh draw per step): an unbiased ~n_samples
                # estimate of the dense similarity, O(n_samples) per step
                coords_f = sample_coords(step_generator(seed, level_index, step),
                                         fixed.shape, n_samples, fixed.device)
                fixed_vals = sample_volume(fixed, coords_f)
            else:
                coords_f, fixed_vals = grid, fixed
            coords = affine_apply(affine, coords_f)
            warped = sample_volume(moving, coords)
            w = inside_weight(coords, moving.shape)
            loss = -sim(warped, fixed_vals, w)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            last = loss.detach()
    return affine.detach(), last


def _pyramid(vol: torch.Tensor, level: int) -> torch.Tensor:
    if level == 1:
        return vol
    return block_mean_downsample(vol, (level, level, level))


def register_affine_multistart(
    fixed: np.ndarray,
    moving: np.ndarray,
    flips=((), (0,), (1,), (2,), (1, 2)),
    coarse_level: int = 4,
    coarse_iters: int = 150,
    device=None,
    timer=None,
    **kwargs,
):
    """Orientation-robust affine: race several axis-flip initializations at
    the coarsest pyramid level, then run the full multi-resolution schedule
    from the winner.

    Gradient descent from the moments init cannot escape a mirrored or
    grossly rotated acquisition (different scanners mount brains
    differently); mBrainAligner's global stage covers this with
    RANSAC/feature matching (reference automate_mBrainaligner.py:29-56
    ``-p r+f+n``). Each candidate init is the moments affine composed with
    a flip of the given fixed axes about the volume center.

    ``timer`` (a ``utils.device.StepSeconds``) gets the steps "moments" and
    "race", and the final schedule's levels.

    Returns ((3, 4) affine, final score, winning flip tuple).
    """
    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)
    with timed(timer, "moments"):
        base = moments_init(fixed, moving)
    candidates = []
    with timed(timer, "race"):
        for flip in flips:
            F = np.eye(4)
            for ax in flip:
                F[ax, ax] = -1.0
                F[ax, 3] = fixed.shape[ax] - 1.0
            init = (np.concatenate([base, [[0, 0, 0, 1]]]) @ F)[:3].astype(
                np.float32
            )
            aff, score = register_affine(
                fixed,
                moving,
                levels=(coarse_level,),
                iters=(coarse_iters,),
                lrs=(0.02,),
                init=init,
                device=device,
                **{
                    k: v
                    for k, v in kwargs.items()
                    if k in ("similarity", "n_samples", "seed")
                },
            )
            candidates.append((score, flip, aff))
    score, flip, aff = max(candidates, key=lambda c: c[0])
    final_aff, final_score = register_affine(
        fixed, moving, init=aff, device=device, timer=timer, **kwargs
    )
    return final_aff, final_score, flip


def register_affine(
    fixed: np.ndarray,
    moving: np.ndarray,
    levels=(4, 2, 1),
    iters=(300, 150, 80),
    lrs=(0.02, 0.01, 0.004),
    init: np.ndarray | None = None,
    verbose: bool = False,
    similarity: str = "ncc",
    n_samples: int = 0,
    seed: int = 0,
    device=None,
    timer=None,
):
    """Returns ((3, 4) affine fixed→moving at full resolution, final score).

    The affine parameters are optimized per pyramid level in that level's
    voxel coordinates, then rescaled: if F_l = F/s, M_l = M/s then
    A_l = S⁻¹ A S with S = diag(s) ⇒ linear part is scale-invariant and the
    translation scales by s.

    ``n_samples > 0`` switches each gradient step to a stochastic
    similarity over that many jittered-lattice fixed-space coordinates
    (elastix-style): O(n_samples) per step instead of O(n_voxels). The
    reported final score is then a DENSE similarity evaluation of the
    returned affine; on the dense path it is the score of the last step,
    before its update, as the JAX package reports it. 0 = dense gradients
    (default). The volumes go to ``device`` (None: the card); ``timer`` gets
    one step "affine_level{level}" per level.
    """
    dev = resolve_device(device)
    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)
    if init is None:
        with timed(timer, "moments"):
            init = moments_init(fixed, moving)
    affine = torch.as_tensor(np.asarray(init, np.float32), device=dev)
    fixed_t = upload(fixed, dev)
    moving_t = upload(moving, dev)

    final_ncc = None
    for li, (level, n_iter, lr) in enumerate(zip(levels, iters, lrs)):
        with timed(timer, f"affine_level{level}"):
            f_l = _pyramid(fixed_t, level)
            m_l = _pyramid(moving_t, level)
            # sampling only where the grid is big, and never at the coarsest
            # level, which does the orientation-critical work (the multistart
            # flip race scores there); see the JAX package's register_affine
            ns = (
                n_samples
                if (n_samples and li > 0 and f_l.numel() > 64 * n_samples)
                else 0
            )
            # move translation into level coords
            aff_l = affine.clone()
            aff_l[:, 3] = affine[:, 3] / level
            aff_l, last = _optimize_level(
                f_l, m_l, aff_l, lr, n_iter, similarity=similarity,
                n_samples=ns, seed=seed, level_index=li,
            )
            final_ncc = -float(last)
            if ns:
                final_ncc = float(dense_score(f_l, m_l, aff_l, similarity))
            affine = aff_l.clone()
            affine[:, 3] = aff_l[:, 3] * level
        if verbose:
            print(f"[affine] level {level}: NCC {final_ncc:.4f}")
    return affine.cpu().numpy(), final_ncc


@torch.no_grad()
def dense_score(fixed, moving, affine, similarity="ncc"):
    """Dense (full-grid) similarity of ``affine`` on a fixed/moving pair —
    the score the stochastic path reports so scores stay comparable."""
    with full_f32():
        grid = fixed_grid(fixed.shape, fixed.device)
        coords = affine_apply(affine, grid)
        warped = sample_volume(moving, coords)
        w = inside_weight(coords, moving.shape)
        return similarity_fn(similarity)(warped, fixed, w)
