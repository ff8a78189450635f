"""Depth-profile analysis: median intensity vs distance-from-surface.

Rebuild of the standalone ``calculate_mask_distance``
(reference: blob_depthmap.py:21-92): anisotropy-aware Euclidean distance
transform of a masked stack, intensities binned by integer depth, median per
bin, exported as CSV + SVG plot.

The port's copy of ``delivr_cfos_tpu/analysis/depth_profile.py``, on the host.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
from scipy.ndimage import distance_transform_edt


def depth_intensity_profile(
    masked_stack: np.ndarray, spacing=(1.0, 1.0, 1.0)
) -> pd.DataFrame:
    """Returns a DataFrame with columns depth_bin (left edge, µm) and
    median_intensity; background (depth 0) excluded."""
    distances = distance_transform_edt(masked_stack > 0, sampling=spacing)
    depth = distances.ravel()
    intensity = np.asarray(masked_stack).ravel()
    keep = depth > 0
    depth = depth[keep]
    intensity = intensity[keep]
    max_bin = int(depth.max()) if depth.size else 1
    bins = np.arange(0, max_bin + 1)
    idx = np.clip(np.digitize(depth, bins) - 1, 0, max_bin - 1)
    medians = np.full(max_bin, np.nan)
    order = np.argsort(idx, kind="stable")
    idx_sorted = idx[order]
    int_sorted = intensity[order]
    boundaries = np.searchsorted(idx_sorted, np.arange(max_bin + 1))
    for b in range(max_bin):
        lo, hi = boundaries[b], boundaries[b + 1]
        if hi > lo:
            medians[b] = np.median(int_sorted[lo:hi])
    return pd.DataFrame({"depth_bin": bins[:-1], "median_intensity": medians})


def calculate_mask_distance(
    masked_stack: np.ndarray,
    output_dir: str,
    sample_name: str,
    spacing=(1.0, 1.0, 1.0),
) -> pd.DataFrame:
    """Full artifact set: per-bin CSV + SVG plot (reference output names
    ``*_combined_data.csv`` / ``*_depthmap_01.svg``)."""
    os.makedirs(output_dir, exist_ok=True)
    profile = depth_intensity_profile(masked_stack, spacing)
    profile.to_csv(os.path.join(output_dir, f"{sample_name}_combined_data.csv"))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.clf()
        plt.plot(profile["depth_bin"], profile["median_intensity"])
        plt.title("depth profile")
        plt.ylabel("median intensity (a.u.)")
        plt.xlabel("depth (µm)")
        plt.savefig(os.path.join(output_dir, f"{sample_name}_depthmap_01.svg"))
    except Exception as e:  # matplotlib optional
        print(f"depth-profile plot skipped: {e}")
    return profile
