"""Training-patch loading from the reference's training_data layout.

The port's copy of ``delivr_cfos_tpu/training/data.py``, numpy only, on the
port's NIfTI reader. The reference ships ``training_data/{cFos,microglia}/
{raw,gt}/patchvolume_*.nii.gz`` pairs — 100³ float64 raw volumes and
uint/RGB-coded ground-truth volumes — with no loader (SURVEY.md §2.4). This
loader pairs files by name, binarizes the gt (any nonzero / nonzero-channel
voxel = 1), and yields (N, D, H, W, 1) float32 batches: with the same seed,
the JAX package's batches, value for value.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from delivr_cfos_tpu_torch.utils.io.nifti import read_nifti_raw


def list_patch_pairs(root: str) -> list:
    """[(raw_path, gt_path)] for patches present in both raw/ and gt/."""
    raws = {
        os.path.basename(p): p
        for p in glob.glob(os.path.join(root, "raw", "*.nii*"))
    }
    gts = {
        os.path.basename(p): p
        for p in glob.glob(os.path.join(root, "gt", "*.nii*"))
    }
    return [(raws[k], gts[k]) for k in sorted(raws.keys() & gts.keys())]


def load_patch_pair(raw_path: str, gt_path: str):
    """Returns (raw float32 (D, H, W), gt uint8 (D, H, W) binarized)."""
    raw = np.asarray(read_nifti_raw(raw_path), np.float32)
    gt = np.asarray(read_nifti_raw(gt_path))
    if gt.ndim == 4:  # RGB-coded gt: any channel nonzero = foreground
        gt = (gt != 0).any(axis=-1)
    return raw, (gt != 0).astype(np.uint8)


def batch_iterator(pairs, batch_size: int, crop: tuple | None = None, seed: int = 0):
    """Infinite iterator of (x, y) batches, shapes (B, D, H, W, 1); random
    crops of ``crop`` when given, else full patches."""
    rng = np.random.default_rng(seed)
    cache = [load_patch_pair(r, g) for r, g in pairs]
    while True:
        xs, ys = [], []
        for _ in range(batch_size):
            raw, gt = cache[rng.integers(len(cache))]
            if crop is not None:
                starts = [
                    rng.integers(0, s - c + 1) for s, c in zip(raw.shape, crop)
                ]
                sl = tuple(slice(st, st + c) for st, c in zip(starts, crop))
                raw_c, gt_c = raw[sl], gt[sl]
            else:
                raw_c, gt_c = raw, gt
            xs.append(raw_c)
            ys.append(gt_c)
        yield (
            np.stack(xs)[..., None].astype(np.float32),
            np.stack(ys)[..., None].astype(np.float32),
        )
