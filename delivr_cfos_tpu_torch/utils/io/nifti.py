"""Minimal NIfTI-1 reader/writer (no nibabel in this image).

Preserves the reference's axis conventions (reference: filehandling.py:6-35):
``write_nifti`` swaps (y, x, z) → (x, y, z) and stamps an RAI affine
diag(−1, −1, 1, 1); ``read_nifti`` swaps back to (y, x, z). The on-disk layout
matches nibabel's output for those calls (dim order x,y,z; Fortran-order data;
sform/qform code 2 with the RAI affine), so files interoperate with the
reference pipeline and its training patches (training_data/cFos/*.nii.gz).
This is the port's copy of ``delivr_cfos_tpu/utils/io/nifti.py``: the files
it writes are byte-equal to the JAX package's (``.nii.gz`` after
decompression: gzip stamps the time).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DT_TO_CODE = {
    np.dtype(np.uint8): (2, 8),
    np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32),
    np.dtype(np.float32): (16, 32),
    np.dtype(np.float64): (64, 64),
    np.dtype(np.uint16): (512, 16),
    np.dtype(np.uint32): (768, 32),
    np.dtype(np.int8): (256, 8),
    np.dtype(np.int64): (1024, 64),
    np.dtype(np.uint64): (1280, 64),
}
_CODE_TO_DT = {code: dt for dt, (code, _) in _DT_TO_CODE.items()}


def _open_maybe_gz(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti_raw(path: str) -> np.ndarray:
    """Read a .nii/.nii.gz into an (x, y, z[, t]) array (disk axis order)."""
    with _open_maybe_gz(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        bo = "<"
        if sizeof_hdr != 348:
            bo = ">"
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
        dim = struct.unpack(bo + "8h", hdr[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + ndim])
        datatype = struct.unpack(bo + "h", hdr[70:72])[0]
        vox_offset = int(struct.unpack(bo + "f", hdr[108:112])[0])
        magic = hdr[344:348]
        if magic not in (b"n+1\0", b"ni1\0"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        if datatype not in _CODE_TO_DT:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = _CODE_TO_DT[datatype].newbyteorder(bo)
        f.read(max(vox_offset - 348, 0))
        count = int(np.prod(shape))
        data = f.read(count * dtype.itemsize)
        arr = np.frombuffer(data, dtype=dtype, count=count)
        # NIfTI data is Fortran-ordered over (x, y, z, ...)
        arr = arr.reshape(shape[::-1]).transpose(range(len(shape))[::-1])
        return arr.astype(dtype.newbyteorder("="))


def write_nifti_raw(
    path: str, volume: np.ndarray, affine: np.ndarray | None = None
) -> None:
    """Write an (x, y, z[, t]) array as .nii or .nii.gz (disk axis order)."""
    volume = np.asarray(volume)
    if affine is None:
        affine = np.eye(4)
    dtype = volume.dtype.newbyteorder("=")
    if np.dtype(dtype) not in _DT_TO_CODE:
        raise ValueError(f"cannot write dtype {dtype} as NIfTI")
    code, bitpix = _DT_TO_CODE[np.dtype(dtype)]
    ndim = volume.ndim
    dim = [ndim] + list(volume.shape) + [1] * (7 - ndim)
    pixdim = [1.0] * 8

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)  # sizeof_hdr
    hdr[38] = ord("r")  # dim_info not set; regular
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)  # datatype
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 252, 2)  # qform_code = aligned
    struct.pack_into("<h", hdr, 254, 2)  # sform_code = aligned
    # srow_x/y/z from affine
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\0"

    payload = bytes(hdr) + b"\0\0\0\0" + np.asfortranarray(
        volume.astype(dtype)
    ).tobytes(order="F")
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


# ---- reference-convention wrappers (filehandling.py semantics) -------------


def write_nifti(path: str, volume: np.ndarray) -> None:
    """Reference-convention writer: takes a (y, x, z) volume, swaps to
    (x, y, z), RAI affine diag(−1, −1, 1, 1) (reference: filehandling.py:6-22)."""
    if ".nii" not in path:
        path = path + ".nii.gz"
    affine = np.eye(4)
    affine[0, 0] = affine[1, 1] = -1
    write_nifti_raw(path, np.swapaxes(volume, 0, 1), affine=affine)


def read_nifti(path: str) -> np.ndarray:
    """Reference-convention reader: returns a (y, x, z) volume
    (reference: filehandling.py:24-35)."""
    if ".nii" not in path:
        path = path + ".nii"
    return np.swapaxes(read_nifti_raw(path), 0, 1)
