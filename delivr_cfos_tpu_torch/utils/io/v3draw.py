"""Vaa3D ``.v3draw`` raw-volume format (replaces the TeraConverter binary, N2).

The reference shells out to TeraConverter to turn 3D TIFFs into .v3draw for
mBrainAligner (reference: downsample/downsample_and_mask.py:49-69). The format
itself is trivial: a 43-byte magic string, 2-byte endian char + datatype,
four int32/int16 dims (x, y, z, c), then raw voxels in x-fastest order.
We write the "raw_image_stack_by_hpeng" v2 layout with 4×int32 dims, which
both Vaa3D and mBrainAligner accept. This is the port's copy of
``delivr_cfos_tpu/utils/io/v3draw.py``.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"raw_image_stack_by_hpeng"  # 24 bytes


def write_v3draw(path: str, volume: np.ndarray) -> None:
    """Write a (z, y, x) or (c, z, y, x) volume as little-endian .v3draw."""
    volume = np.asarray(volume)
    if volume.ndim == 3:
        volume = volume[None]
    c, z, y, x = volume.shape
    if volume.dtype == np.uint8:
        nbytes = 1
    elif volume.dtype == np.uint16:
        nbytes = 2
    elif volume.dtype == np.float32:
        nbytes = 4
    else:
        raise ValueError(f".v3draw supports uint8/uint16/float32, got {volume.dtype}")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(b"L")  # little-endian
        f.write(struct.pack("<h", nbytes))
        f.write(struct.pack("<4i", x, y, z, c))
        # voxel order: x fastest, then y, z, c
        f.write(np.ascontiguousarray(volume).tobytes())


def read_v3draw(path: str) -> np.ndarray:
    """Read a .v3draw; returns (c, z, y, x) (squeezed to (z, y, x) if c==1)."""
    with open(path, "rb") as f:
        magic = f.read(24)
        if magic != _MAGIC:
            raise ValueError(f"{path}: bad v3draw magic {magic!r}")
        endian = f.read(1)
        bo = "<" if endian == b"L" else ">"
        nbytes = struct.unpack(bo + "h", f.read(2))[0]
        dims_raw = f.read(16)
        x, y, z, c = struct.unpack(bo + "4i", dims_raw)
        # some writers use 2-byte dims; detect implausible sizes and re-parse
        if min(x, y, z, c) <= 0 or any(v > 1 << 28 for v in (x, y, z, c)):
            x, y, z, c = struct.unpack(bo + "4h", dims_raw[:8])
            f.seek(24 + 3 + 8)
        dtype = {1: np.uint8, 2: np.uint16, 4: np.float32}[nbytes]
        arr = np.frombuffer(f.read(x * y * z * c * nbytes), dtype=np.dtype(dtype).newbyteorder(bo))
        arr = arr.reshape(c, z, y, x).astype(np.dtype(dtype).newbyteorder("="))
        return arr[0] if c == 1 else arr
