"""Stage 5's heatmap on the device: a count volume and its Gaussian blur.

The counterpart of ``np.add.at(heatmap, (z, y, x), 1.0)`` and
``scipy.ndimage.gaussian_filter(heatmap, sigma, output=heatmap)`` of
``delivr_cfos_tpu/pipeline/stage05_region_assignment.py::create_heatmap``,
with scipy's numbers, not merely close to them:

- scipy's ``mode='reflect'`` extends a line half-sample symmetrically
  (``d c b a | a b c d | d c b a``) and repeats that with period 2n on a
  line shorter than the filter's radius: ``_reflect_index``. This is
  numpy's ``'symmetric'`` pad, not its ``'reflect'``, which
  ``ops/features.py`` builds.
- scipy filters one axis at a time, 0, 1, 2, each line in float64, and
  rounds to the output's float32 after each axis. Its weights are
  ``_gaussian_kernel1d``: ``exp(-0.5 / σ² · x²)`` over x in [−r, r],
  r = int(truncate · σ + 0.5), divided by their sum, in float64.
- For a symmetric kernel scipy's loop starts from ``x[0] · w[0]`` and adds
  ``(x[−j] + x[+j]) · w[j]`` for j = r down to 1 (``NI_Correlate1D``).
  Each of those operations is one torch operation here, rounded alone, so
  nothing is contracted into a fused multiply-add, and the result equals
  scipy's bit for bit on the CPU and on the card (``tests/test_torch_stage05.py``,
  ``tests/test_torch_cuda_stage0506.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def scatter_counts(shape, z, y, x, device) -> torch.Tensor:
    """A float32 volume of ``shape`` on ``device`` holding at each voxel the
    number of (z, y, x) index triples that hit it. Counts below 2^24 are
    exact in float32 whatever the order of the adds."""
    vol = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    idx = tuple(torch.from_numpy(np.array(a, np.int64)).to(device) for a in (z, y, x))
    ones = torch.ones(idx[0].shape, dtype=torch.float32, device=device)
    vol.index_put_(idx, ones, accumulate=True)
    return vol


def gaussian_weights(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy's ``_gaussian_kernel1d(sigma, 0, radius)``: float64, length
    2r + 1, summing to 1."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (float(sigma) * float(sigma)) * x**2)
    return phi / phi.sum()


def _reflect_index(n: int, radius: int, device) -> torch.Tensor:
    """Source index of each position in [−radius, n + radius) of a line of
    ``n`` under scipy's 'reflect' extension, for any n ≥ 1."""
    p = torch.arange(-radius, n + radius, device=device)
    m = torch.remainder(p, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def _filter_axis(vol: torch.Tensor, axis: int, weights: np.ndarray) -> torch.Tensor:
    radius = len(weights) // 2
    n = vol.shape[axis]
    line = vol.to(torch.float64).index_select(axis, _reflect_index(n, radius, vol.device))

    def tap(j):  # the extended line shifted by j: x[i + j] for i in [0, n)
        return line.narrow(axis, radius + j, n)

    out = tap(0) * float(weights[radius])
    for j in range(radius, 0, -1):
        out = out + (tap(-j) + tap(j)) * float(weights[radius - j])
    return out.to(torch.float32)


def gaussian_filter_reflect(vol: torch.Tensor, sigma: float,
                            truncate: float = 4.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(vol, sigma, mode='reflect',
    truncate=truncate)`` of a float32 volume, on the volume's device, with
    scipy's rounding (see the module docstring). Returns float32."""
    if vol.dtype != torch.float32:
        raise TypeError(f"gaussian_filter_reflect takes float32, got {vol.dtype}")
    weights = gaussian_weights(sigma, truncate)
    for axis in range(vol.ndim):
        vol = _filter_axis(vol, axis, weights)
    return vol
