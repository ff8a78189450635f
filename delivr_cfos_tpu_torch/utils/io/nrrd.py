"""Minimal NRRD reader/writer — enough for Allen Institute atlas volumes.

The Allen 50 µm average template (``average_template_50.nrrd``) and the
CCFv3 annotation volumes ship as NRRD: a text header followed by (optionally
gzip-compressed) raw voxels. The framework's registration stage consumes the
template via ``atlas_alignment.template_file`` (tif/v3draw/npy/nrrd);
``scripts/fetch_allen_template.py`` documents how to obtain and convert it.
This is the port's copy of ``delivr_cfos_tpu/utils/io/nrrd.py``: the files
it writes are byte-equal to the JAX package's.

Supports: detached=false single-file NRRD0004/5, types {uint8, uint16,
int16, uint32, int32, float, double}, encodings {raw, gzip}, little/big
endian, 3-D sizes. That covers every Allen informatics volume.
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np

_TYPES = {
    "uchar": np.uint8,
    "unsigned char": np.uint8,
    "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16,
    "int16": np.int16,
    "int16_t": np.int16,
    "ushort": np.uint16,
    "unsigned short": np.uint16,
    "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32,
    "unsigned int": np.uint32,
    "uint32": np.uint32,
    "uint32_t": np.uint32,
    "float": np.float32,
    "double": np.float64,
}


def read_nrrd(path: str) -> tuple[np.ndarray, dict]:
    """Read a single-file NRRD → (array indexed [slowest..fastest axis],
    header dict). NRRD stores sizes fastest-axis-first; the returned array
    axes are reversed so ``arr.shape == sizes[::-1]`` (C order), matching
    how tifffile-style readers expose Allen volumes."""
    with open(path, "rb") as f:
        data = f.read()
    magic_end = data.index(b"\n")
    magic = data[:magic_end]
    if not magic.startswith(b"NRRD"):
        raise ValueError(f"{path} is not a NRRD file")
    header: dict[str, str] = {}
    pos = magic_end + 1
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].rstrip(b"\r")
        pos = end + 1
        if not line:
            break  # blank line terminates the header
        if line.startswith(b"#"):
            continue
        if b":=" in line:
            k, v = line.split(b":=", 1)
        elif b": " in line or line.endswith(b":"):
            k, v = line.split(b":", 1)
        else:
            raise ValueError(f"malformed NRRD header line {line!r}")
        header[k.strip().decode().lower()] = v.strip().decode()

    if header.get("data file"):
        raise NotImplementedError("detached NRRD data files not supported")
    dtype = _TYPES.get(header.get("type", "").strip())
    if dtype is None:
        raise NotImplementedError(f"NRRD type {header.get('type')!r}")
    sizes = [int(s) for s in header["sizes"].split()]
    endian = header.get("endian", "little")
    enc = header.get("encoding", "raw").lower()
    raw = data[pos:]
    if enc in ("gzip", "gz"):
        try:
            raw = gzip.decompress(raw)
        except OSError:
            raw = zlib.decompress(raw)
    elif enc != "raw":
        raise NotImplementedError(f"NRRD encoding {enc!r}")
    dt = np.dtype(dtype).newbyteorder("<" if endian == "little" else ">")
    n = int(np.prod(sizes))
    arr = np.frombuffer(raw, dtype=dt, count=n)
    # sizes are fastest-first → C-order shape is reversed
    return arr.reshape(sizes[::-1]).astype(dtype), header


def write_nrrd(
    path: str, arr: np.ndarray, encoding: str = "gzip", extra: dict | None = None
) -> None:
    """Write a single-file NRRD (C-order array; sizes emitted fastest-first)."""
    arr = np.ascontiguousarray(arr)
    type_name = {
        np.dtype(np.uint8): "uint8",
        np.dtype(np.uint16): "uint16",
        np.dtype(np.int16): "int16",
        np.dtype(np.uint32): "uint32",
        np.dtype(np.int32): "int32",
        np.dtype(np.float32): "float",
        np.dtype(np.float64): "double",
    }.get(arr.dtype)
    if type_name is None:
        raise NotImplementedError(f"dtype {arr.dtype}")
    lines = [
        "NRRD0004",
        "# written by delivr_cfos_tpu",
        f"type: {type_name}",
        f"dimension: {arr.ndim}",
        f"sizes: {' '.join(str(s) for s in arr.shape[::-1])}",
        f"encoding: {encoding}",
        "endian: little",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    payload = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    if encoding == "gzip":
        payload = gzip.compress(payload, 1)
    elif encoding != "raw":
        raise NotImplementedError(encoding)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode())
        f.write(payload)
