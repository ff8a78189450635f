"""Ilastik-style per-voxel feature bank as torch ops (separable Gaussian
filters).

The port's counterpart of ``delivr_cfos_tpu/ops/features.py``. Ilastik's
pixel classification computes a bank of image filters per voxel and feeds
them to a random forest (reference: the external Ilastik binary invoked at
downsample/downsample_and_mask.py:75-83). The standard bank — Gaussian
smoothing, Laplacian of Gaussian, Gaussian gradient magnitude, and
difference of Gaussians over a scale set — is built from separable 1D
filters.

Each 1D filter is a sum of shifted slices, one multiply and one add per tap
in tap order, each rounded to float32, and square roots are rounded once
from float64. No library convolution runs: cuDNN would take TF32 on the card
and sum in an order of its own, and the features feed the forest's
threshold comparisons, where one rounding flips a branch. So every feature
but the eigenvalues (arccos and cos round differently on the card) has the
same bits on the card and on the CPU. The JAX package convolves with
``conv_general_dilated``, whose sums run in XLA's order: the two agree to
float32 rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_SIGMAS = (0.7, 1.6, 3.5)


def _gauss_kernel(sigma: float, order: int = 0) -> np.ndarray:
    """1D Gaussian (order 0), first derivative (1), or second derivative (2),
    matching scipy.ndimage conventions (truncate=4)."""
    radius = max(int(4.0 * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    if order == 0:
        return g
    if order == 1:
        return g * (-x / sigma**2)
    if order == 2:
        return g * ((x**2 - sigma**2) / sigma**4)
    raise ValueError(order)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each of the ``n + 2r`` positions of ``numpy.pad(...,
    r, mode="reflect")`` (the edge is not repeated; a pad of ``n`` or more
    reflects again, as numpy and ``jnp.pad`` do, where ``F.pad`` refuses)."""
    j = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * (n - 1)
    m = torch.remainder(j, period)
    return torch.where(m < n, m, period - m)


def _sep_conv(vol: torch.Tensor, kernels) -> torch.Tensor:
    """Separable 3D convolution with per-axis 1D kernels (None skips an
    axis), numpy-reflect padding; float32 in, float32 out."""
    x = vol
    for axis, k in enumerate(kernels):
        if k is None:
            continue
        # convolution: tap t of the flipped kernel meets padded position i + t
        taps = [float(v) for v in np.asarray(k, np.float32)[::-1]]
        r = (len(taps) - 1) // 2
        n = x.shape[axis]
        xp = x.index_select(axis, _reflect_index(n, r, x.device))
        acc = xp.narrow(axis, 0, n) * taps[0]
        for t in range(1, len(taps)):
            acc += xp.narrow(axis, t, n) * taps[t]
        x = acc
    return x


# --------------------------------------------------------------------------
# Ilastik-compatible feature bank (for .ilp-imported classifiers)
# --------------------------------------------------------------------------

# canonical Ilastik pixel-classification feature ids, in the order the GUI
# (and the .ilp SelectionMatrix rows) list them
ILASTIK_FEATURE_IDS = (
    "GaussianSmoothing",
    "LaplacianOfGaussian",
    "GaussianGradientMagnitude",
    "DifferenceOfGaussians",
    "StructureTensorEigenvalues",
    "HessianOfGaussianEigenvalues",
)


def _eigvals_sym3(a11, a22, a33, a12, a13, a23):
    """Eigenvalues of a symmetric 3×3 per-voxel field, descending — closed
    form (trigonometric/Cardano), fully vectorized."""
    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0 * (a12 * a12 + a13 * a13 + a23 * a23)
    p = _sqrt_f32(torch.clamp(p2 / 6.0, min=1e-30))
    # det((A − qI)/p) / 2
    detb = (
        b11 * (b22 * b33 - a23 * a23)
        - a12 * (a12 * b33 - a23 * a13)
        + a13 * (a12 * a23 - b22 * a13)
    )
    r = torch.clamp(detb / (2.0 * (p * p * p)), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    degen = p2 < 1e-20
    return (
        torch.where(degen, q, e1),
        torch.where(degen, q, e2),
        torch.where(degen, q, e3),
    )


def _deriv_conv(x, sigma, orders):
    """Gaussian-derivative filter with per-axis derivative orders (z, y, x)."""
    ks = tuple(_gauss_kernel(sigma, o) for o in orders)
    return _sep_conv(x, ks)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device: through
    float64, whose square root is exact before the one rounding to float32
    (CUDA's float32 ``torch.sqrt`` may differ from the CPU's in the last
    bit)."""
    return torch.sqrt(x.double()).float()


def _grad_magnitude(gz, gy, gx):
    return _sqrt_f32(gz * gz + gy * gy + gx * gx + 1e-12)


def ilastik_feature_bank(vol: torch.Tensor, spec: tuple) -> torch.Tensor:
    """(Z, Y, X) volume → (Z, Y, X, F) float32 features for an Ilastik
    feature selection ``spec`` = tuple of (feature_id, sigma) in .ilp
    SelectionMatrix order (feature ids outer, scales inner).

    Filter definitions follow ilastik's (lazyflow OpPixelFeaturesPresmoothed
    semantics, computed exactly at σ rather than via ilastik's presmoothed
    pyramid approximation):
      DifferenceOfGaussians(σ)        = gauss(σ) − gauss(0.66·σ)
      StructureTensorEigenvalues(σ)   : inner scale σ, outer scale σ/2,
                                        3 eigenvalues descending
      HessianOfGaussianEigenvalues(σ) : 3 eigenvalues descending
    """
    x = vol.float()
    feats = []
    for fid, s in spec:
        s = float(s)
        if fid == "GaussianSmoothing":
            g = _gauss_kernel(s, 0)
            feats.append(_sep_conv(x, (g, g, g)))
        elif fid == "LaplacianOfGaussian":
            feats.append(
                _deriv_conv(x, s, (2, 0, 0))
                + _deriv_conv(x, s, (0, 2, 0))
                + _deriv_conv(x, s, (0, 0, 2))
            )
        elif fid == "GaussianGradientMagnitude":
            feats.append(_grad_magnitude(_deriv_conv(x, s, (1, 0, 0)),
                                         _deriv_conv(x, s, (0, 1, 0)),
                                         _deriv_conv(x, s, (0, 0, 1))))
        elif fid == "DifferenceOfGaussians":
            g1 = _gauss_kernel(s, 0)
            g2 = _gauss_kernel(0.66 * s, 0)
            feats.append(_sep_conv(x, (g1, g1, g1)) - _sep_conv(x, (g2, g2, g2)))
        elif fid == "StructureTensorEigenvalues":
            gz = _deriv_conv(x, s, (1, 0, 0))
            gy = _deriv_conv(x, s, (0, 1, 0))
            gx = _deriv_conv(x, s, (0, 0, 1))
            go = _gauss_kernel(s / 2.0, 0)
            sm = lambda t: _sep_conv(t, (go, go, go))  # noqa: E731
            feats += _eigvals_sym3(
                sm(gz * gz), sm(gy * gy), sm(gx * gx),
                sm(gz * gy), sm(gz * gx), sm(gy * gx),
            )
        elif fid == "HessianOfGaussianEigenvalues":
            feats += _eigvals_sym3(
                _deriv_conv(x, s, (2, 0, 0)),
                _deriv_conv(x, s, (0, 2, 0)),
                _deriv_conv(x, s, (0, 0, 2)),
                _deriv_conv(x, s, (1, 1, 0)),
                _deriv_conv(x, s, (1, 0, 1)),
                _deriv_conv(x, s, (0, 1, 1)),
            )
        else:
            raise ValueError(f"unknown Ilastik feature id {fid!r}")
    return torch.stack(feats, dim=-1)


def feature_bank(vol: torch.Tensor, sigmas: tuple = DEFAULT_SIGMAS) -> torch.Tensor:
    """(Z, Y, X) volume → (Z, Y, X, F) float32 feature stack.

    F = 1 (raw) + per σ: smoothing, LoG, gradient magnitude; plus
    difference-of-Gaussians between consecutive σ.
    """
    x = vol.float()
    feats = [x]
    smoothed = []
    for s in sigmas:
        g = _gauss_kernel(s, 0)
        sm = _sep_conv(x, (g, g, g))
        smoothed.append(sm)
        feats.append(sm)
        # Laplacian of Gaussian: sum of per-axis second derivatives
        d2 = _gauss_kernel(s, 2)
        feats.append(
            _sep_conv(x, (d2, g, g))
            + _sep_conv(x, (g, d2, g))
            + _sep_conv(x, (g, g, d2))
        )
        d1 = _gauss_kernel(s, 1)
        feats.append(_grad_magnitude(_sep_conv(x, (d1, g, g)),
                                     _sep_conv(x, (g, d1, g)),
                                     _sep_conv(x, (g, g, d1))))
    for a, b in zip(smoothed, smoothed[1:]):
        feats.append(a - b)
    return torch.stack(feats, dim=-1)
