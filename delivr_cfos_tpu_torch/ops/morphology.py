"""Binary morphology on the device: the reference's binarization chain.

The reference binarizes UNet output blockwise: sigmoid → ≥ threshold →
re-derive the > 0 mask from the input volume → 30-iteration binary erosion
with the default 6-connected cross and ``border_value=1`` → AND into the
thresholded output (reference: inference/inference.py:31-95).

``border_value=1`` means voxels outside the array behave as foreground, so
block or slab cuts never erode inward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _erode_once(x: torch.Tensor) -> torch.Tensor:
    """One erosion step with the 3D 6-connected cross; outside counts as 1."""
    p = F.pad(x, (1, 1, 1, 1, 1, 1), value=1)
    c = p[1:-1, 1:-1, 1:-1]
    out = torch.minimum(c, p[:-2, 1:-1, 1:-1])
    out = torch.minimum(out, p[2:, 1:-1, 1:-1])
    out = torch.minimum(out, p[1:-1, :-2, 1:-1])
    out = torch.minimum(out, p[1:-1, 2:, 1:-1])
    out = torch.minimum(out, p[1:-1, 1:-1, :-2])
    return torch.minimum(out, p[1:-1, 1:-1, 2:])


def binary_erosion_cross(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """``scipy.ndimage.binary_erosion(mask, iterations=n, border_value=1)``
    with the default cross, for a (Z, Y, X) mask; returns uint8."""
    x = (mask > 0).to(torch.uint8)
    for _ in range(max(iterations, 0)):
        x = _erode_once(x)
    return x


def binarize_logits(mean_logits, input_volume, threshold: float = 0.5,
                    erosion_iters: int = 30) -> torch.Tensor:
    """sigmoid(mean_logits) ≥ threshold, AND the eroded (input > 0) mask;
    uint8 (Z, Y, X) on the logits' device."""
    seg = (torch.sigmoid(mean_logits.float()) >= threshold).to(torch.uint8)
    return seg * binary_erosion_cross(input_volume > 0, erosion_iters)
