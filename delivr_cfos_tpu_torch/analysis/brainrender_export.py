"""Brainrender-compatible point-cloud exports.

Rebuild of the data-preparation side of the reference's offline
brainrender script (reference: 2021_preprocess_for_brainrender_v13.py):
registered cell coordinates are converted into µm-scale CCF coordinates and
exported as .npy point clouds that brainrender/vedo (not installed in this
image) consume directly. Rendering itself stays external, as in the
reference (the script is out-of-pipeline, SURVEY.md §2.1 P13).

The port's copy of ``delivr_cfos_tpu/analysis/brainrender_export.py``, on the host.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from delivr_cfos_tpu_torch.analysis.brainrender_render import (  # noqa: F401
    CAMERAS,
    render_screenshot,
    render_video,
)


def mbrainaligner_atlas_to_ccf_um(cells: pd.DataFrame) -> np.ndarray:
    """The brainrender-variant coordinate transform
    (reference: 2021_preprocess_for_brainrender_v13.py:309-331): flip
    x (528−x) and y (320−y) in 25 µm CCF space, apply the empirically
    determined padding offsets (−210 x, +200 y), scale ×25 to µm. Input
    columns x, y, z; returns (N, 3) float64."""
    cells = cells.copy()
    cells["x"] = 528 - cells["x"]
    cells["y"] = 320 - cells["y"]
    cells["x"] = cells["x"] - 210
    cells["y"] = cells["y"] + 200
    cells[["x", "y", "z"]] = cells[["x", "y", "z"]] * 25
    return cells[["x", "y", "z"]].to_numpy(np.float64)


def export_cells_for_brainrender(
    cells_csv: str,
    output_dir: str,
    mouse_name: str,
    region_acronyms: list | None = None,
) -> str:
    """Load a stage-5 ``cells_{mouse}.csv``, optionally filter to regions,
    transform to µm CCF coordinates, save ``{mouse}_cells_um.npy``."""
    os.makedirs(output_dir, exist_ok=True)
    cells = pd.read_csv(cells_csv, index_col=0)
    if region_acronyms:
        cells = cells[cells["acronym"].isin(region_acronyms)]
    # stage-5 cells are in 25 µm CCF voxel indices; brainrender wants µm in
    # the (AP, DV, ML) = (z, y, x)·25 frame
    pts = cells[["z", "y", "x"]].to_numpy(np.float64) * 25.0
    out = os.path.join(output_dir, f"{mouse_name}_cells_um.npy")
    np.save(out, pts)
    return out
