"""Shared pipeline helpers (the port's copy of
``delivr_cfos_tpu/pipeline/common.py``)."""

from __future__ import annotations

import glob
import os

from delivr_cfos_tpu_torch.utils.io.tiff import tiff_page_infos


def list_raw_tiffs(raw_folder: str) -> list:
    """Sorted list of .tif z-planes in a brain folder
    (reference: downsample/downsample_and_mask.py:146)."""
    return sorted(glob.glob(os.path.join(raw_folder, "*.tif")))


def get_real_size(raw_folder: str) -> tuple:
    """(z, y, x) of the raw stack: z = number of .tif files, y/x from the
    first plane's header (reference: downsample/downsample_and_mask.py:25-30).
    Header-only read — no pixel decode."""
    tifs = list_raw_tiffs(raw_folder)
    info = tiff_page_infos(tifs[0])[0]
    y, x = info.shape[0], info.shape[1]
    return (len(tifs), y, x)
