"""Napari console snippet for stage-6 RGB output, as a callable.

Rebuild of the reference's copy-paste console script
(reference: misc_files/napari_load_delivr_rgb_output_v01.txt): loads the
``{brain}_rgb_tiffs/*C00/C01/C02*`` plane triplets as additive red/green/
blue layers with the anisotropic µm scale and a 1 mm scale bar. Uses the
in-framework TIFF codec (tifffile is not a dependency); napari itself is
the interactive viewer and stays external.

Usage in the napari console:

    from delivr_cfos_tpu_torch.analysis.napari_loader import load_rgb_output
    load_rgb_output(viewer, "/data/output/06_visualization/output/ctrl_3_rgb_tiffs/")

The port's copy of ``delivr_cfos_tpu/analysis/napari_loader.py``, on the host.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff


def _stack(paths) -> np.ndarray:
    return np.stack([np.asarray(read_tiff(p)) for p in paths])


def load_rgb_output(
    viewer,
    input_folder: str,
    scale=(3.0, 4.75, 4.75),
    scale_bar_um: float = 1000.0,
):
    """Add the three channel stacks to an open napari viewer (additive
    red/green/blue, reference scale [3.0, 4.75, 4.75] µm)."""
    for tag, cmap in (("C00", "red"), ("C01", "green"), ("C02", "blue")):
        paths = sorted(glob.glob(os.path.join(input_folder, f"*{tag}*")))
        if not paths:
            continue
        viewer.add_image(
            _stack(paths),
            colormap=cmap,
            blending="additive",
            scale=list(scale),
        )
    viewer.scale_bar.unit = "um"
    viewer.scale_bar.length = scale_bar_um
    viewer.scale_bar.visible = True
    return viewer
