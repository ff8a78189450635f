"""The comparison that decides ``correct``: a binaries volume that stage 2
wrote against the reference's decision over the same input.

Three numbers, each with a limit that the configuration file states:

- ``outside_mask``: voxels set where the reference's eroded input mask is
  clear, or set to anything but 0 or 1. The mask is exact arithmetic, so
  the limit is 0.
- ``flip_margin``: the largest |reference mean logit| at a voxel inside the
  mask where the two binaries differ. A lower precision flips voxels whose
  logit lies near the cut; a voxel flipped far from it is a fault.
- ``flip_share``: the voxels flipped inside the mask, as a share of the
  mask's voxels: how many lie near enough to the cut to flip.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("outside_mask", "flip_margin", "flip_share")


def compare(binaries: np.ndarray, ref: dict, planes: int = 64) -> dict:
    """``binaries``: the (Z, Y, X) uint8 output (a memmap is read in blocks
    of ``planes``); ``ref``: the reference's ``mean``, ``mask`` and
    ``binary`` on the device."""
    mean, mask, want = ref["mean"], ref["mask"], ref["binary"]
    if tuple(binaries.shape) != tuple(mean.shape):
        return {"outside_mask": float(np.prod(mean.shape)), "flip_margin": 1e30,
                "flip_share": 1.0}
    outside = 0
    flips = 0
    margin = 0.0
    for z0 in range(0, mean.shape[0], planes):
        got = torch.from_numpy(np.array(binaries[z0:z0 + planes])).to(mean.device)
        m = mask[z0:z0 + planes]
        outside += int(((got != 0) & ~m).sum()) + int((got > 1).sum())
        diff = (got.bool() != want[z0:z0 + planes]) & m
        n = int(diff.sum())
        if n:
            flips += n
            margin = max(margin, float(mean[z0:z0 + planes][diff].abs().max()))
    n_mask = int(mask.sum())
    return {"outside_mask": float(outside), "flip_margin": margin,
            "flip_share": flips / max(n_mask, 1)}


def worst(readings: list[dict]) -> dict:
    """The largest of each number over several outputs."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def within(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
