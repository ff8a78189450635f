"""ctypes wrappers for the native TIFF strip codecs (tiff_codec.cpp; the
port's copy of ``delivr_cfos_tpu/native/tiff.py``)."""

from __future__ import annotations

import os

import numpy as np

from delivr_cfos_tpu_torch.native.build import get_library


def decode_native(kind: str, data: bytes, dst_cap: int):
    """Decode one LZW ('lzw') or PackBits ('packbits') strip/tile natively.
    ``dst_cap`` is the maximum decoded size (strip geometry × itemsize).
    Returns a zero-copy memoryview of the decoded bytes, or None when the
    native library is unavailable or the stream needs the Python fallback."""
    lib = get_library("tiff_codec")
    if lib is None or not data:
        return None
    fn = (
        lib.tiff_lzw_decode if kind == "lzw" else lib.tiff_packbits_decode
    )
    dst = np.empty(dst_cap, np.uint8)
    # bytes pass as a read-only pointer (no copy) for c_void_p args
    n = fn(data, len(data), dst.ctypes.data, dst_cap)
    if n < 0:
        return None
    return memoryview(dst)[: int(n)]


def decode_strips_native(
    kind: int,
    strips: list,
    dst_caps: np.ndarray,
    n_threads: int = 0,
):
    """Decode all LZW (kind 5) / PackBits (kind 32773) strips of a page in
    ONE native call, multi-threaded in C++ (the per-strip ctypes round trip
    costs more than decoding a common 2-row strip). ``strips`` is a list of
    compressed bytes; ``dst_caps`` the EXACT decoded size per strip (short
    last strips get a reduced cap upstream). Returns a uint8 array holding
    the concatenated decoded strips plus the per-strip offsets, or None on
    fallback — including any strip decoding short of its cap, so truncated
    streams surface via the loud Python decoder instead of black rows."""
    lib = get_library("tiff_codec")
    if lib is None or not strips:
        return None
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    src = b"".join(strips)
    src_lens = np.asarray([len(s) for s in strips], np.int64)
    # keep every converted array bound to a local before taking .ctypes.data:
    # an inline ascontiguousarray(...) temporary could be freed before the
    # C call runs if the conversion ever copies
    src_offs = np.ascontiguousarray(
        np.concatenate([[0], np.cumsum(src_lens)[:-1]]), np.int64
    )
    caps = np.ascontiguousarray(dst_caps, np.int64)
    dst_offs = np.ascontiguousarray(
        np.concatenate([[0], np.cumsum(caps)[:-1]]), np.int64
    )
    dst = np.empty(int(caps.sum()), np.uint8)
    rc = lib.tiff_decode_strips(
        src,
        src_offs.ctypes.data,
        src_lens.ctypes.data,
        len(strips),
        dst.ctypes.data,
        dst_offs.ctypes.data,
        caps.ctypes.data,
        int(kind),
        int(n_threads),
    )
    if rc != 0:
        return None
    return dst, dst_offs
