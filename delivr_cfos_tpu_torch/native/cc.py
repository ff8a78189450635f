"""ctypes wrappers for the native connected-components library (the port's
copy of ``delivr_cfos_tpu/native/cc.py``)."""

from __future__ import annotations

import numpy as np

from delivr_cfos_tpu_torch.native.build import get_library


def cc_label_native(binary: np.ndarray):
    """26-connected labeling via the C++ union-find; returns
    (labels int32, n) or None if the native library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    if binary.dtype == np.uint8 and binary.flags["C_CONTIGUOUS"]:
        # the C scan treats any nonzero byte as foreground, so an existing
        # uint8 buffer needs no normalization copy
        vol = binary
    else:
        vol = np.ascontiguousarray((binary > 0).astype(np.uint8))
    out = np.empty(vol.shape, np.int32)
    z, y, x = vol.shape
    n = lib.cc_label_u8(vol.ctypes.data, z, y, x, out.ctypes.data)
    if n < 0:
        return None  # label overflow; caller falls back
    return out, int(n)


def cc_statistics_native(labels: np.ndarray, n: int):
    """Counts/centroids/bboxes via the C++ single sweep; None if unavailable.
    Returns the same dict layout as
    ``delivr_cfos_tpu_torch.ops.connected_components.component_statistics``."""
    lib = get_library()
    if lib is None:
        return None
    if labels.dtype == np.int32 and labels.flags["C_CONTIGUOUS"]:
        lab = labels  # no copy: astype always copies, 4 B/voxel
    else:
        lab = np.ascontiguousarray(labels.astype(np.int32))
    z, y, x = lab.shape
    counts = np.zeros(n + 1, np.int64)
    csums = np.zeros((n + 1, 3), np.float64)
    bbox = np.zeros((n + 1, 6), np.int64)
    lib.cc_statistics_i32(lab.ctypes.data, z, y, x, n, counts.ctypes.data,
                          csums.ctypes.data, bbox.ctypes.data)
    with np.errstate(invalid="ignore", divide="ignore"):
        centroids = csums / counts[:, None].astype(np.float64)
    centroids[counts == 0] = np.nan
    return {
        "voxel_counts": counts,
        "centroids": centroids,
        "bounding_boxes": bbox,
    }
