"""Stage 6's per-label lookup on the device: ``lut[labels]`` over z-chunks
of a label volume too large for the card.

The counterpart of the per-plane ``lut[np.asarray(labels[z])]`` of
``delivr_cfos_tpu/pipeline/stage06_visualization.py::_apply_lut_per_plane``.
A chunk of the int32 label memmap is uploaded, gathered on the device and
copied back in the table's dtype; the gather is exact, so the planes equal
numpy's. uint16 tables travel as their int16 bit pattern (PyTorch's uint16
support is partial).
"""

from __future__ import annotations

import numpy as np
import torch

# a chunk's int32 labels and gathered values take at most this many bytes,
# and at most this share of the card's free memory
_CHUNK_BYTES = 2 * 2**30
_DEVICE_SHARE = 0.25


def lut_chunk_planes(plane_shape, lut: np.ndarray, device) -> int:
    """z-planes per chunk: a chunk's int32 labels and its gathered values
    fit in 2 GiB and, on a card, in a quarter of its free memory. The 2 GiB
    also bound the host copies of the chunks in flight."""
    device = torch.device(device)
    budget = _CHUNK_BYTES
    if device.type == "cuda":
        budget = min(budget, int(torch.cuda.mem_get_info(device)[0] * _DEVICE_SHARE))
    per_plane = int(np.prod(plane_shape)) * (4 + lut[:1].nbytes)
    return max(1, budget // per_plane)


def apply_lut(labels_chunk, lut: np.ndarray, device) -> np.ndarray:
    """``lut[labels_chunk]`` computed on ``device``: a host int32 array
    (a slice of a memmap, typically) of shape S and a table of shape (n + 1,)
    or (n + 1, c) give a host array of shape S or S + (c,) in the table's
    dtype. Labels must lie in [0, n]."""
    device = torch.device(device)
    table = np.ascontiguousarray(lut)
    if table.dtype == np.uint16:
        table = table.view(np.int16)
    lut_t = torch.from_numpy(table).to(device)
    lab = torch.from_numpy(np.require(labels_chunk, np.int32, ["C", "W"])).to(device)
    out = lut_t.index_select(0, lab.reshape(-1))
    out = out.reshape(*lab.shape, *table.shape[1:]).cpu().numpy()
    return out.view(lut.dtype)
