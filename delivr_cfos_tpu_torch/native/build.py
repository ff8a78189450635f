"""Build the native libraries (g++ → shared objects) at first use, and load
them with ctypes.

Each source builds into a library of its own, so a missing or broken one
disables only its callers: ``cc_label.cpp`` (the connected-components
labeler and statistics sweep of stage 3) and ``tiff_codec.cpp`` (the LZW and
PackBits strip decoders of the TIFF reader). A library compiles into
``<repo>/build/native/<hash>/`` (the hash covers the source and the flags),
not beside the sources: a changed source builds anew, an unchanged one loads
the library already there. The libraries have a plain C interface, so no
Python headers are needed. Where g++ or a source is missing or the build
fails, ``get_library`` returns None and the callers take their Python
engines (scipy, the Python decoders), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)), "build", "native")
# no -march=native: the library may be loaded on another host than it was
# built on (a copy of the checkout with its build directory)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_I64, _PTR = ctypes.c_int64, ctypes.c_void_p
# library name → {function: (restype, argtypes)}
_SIGNATURES = {
    "cc_label": {
        "cc_label_u8": (_I64, [_PTR, _I64, _I64, _I64, _PTR]),
        "cc_statistics_i32": (None, [_PTR, _I64, _I64, _I64, _I64, _PTR, _PTR, _PTR]),
    },
    "tiff_codec": {
        "tiff_lzw_decode": (_I64, [_PTR, _I64, _PTR, _I64]),
        "tiff_packbits_decode": (_I64, [_PTR, _I64, _PTR, _I64]),
        # src, src_offs, src_lens, n_strips, dst, dst_offs, dst_caps, kind, n_threads
        "tiff_decode_strips": (_I64, [_PTR, _PTR, _PTR, _I64, _PTR, _PTR, _PTR, _I64, _I64]),
    },
}

_LOCK = threading.Lock()
_LIBS: dict = {}  # name → loaded library, or None once a build or load failed


def library_path(name: str) -> str:
    """Where the library built from ``native/<name>.cpp`` lives."""
    with open(os.path.join(_SRC_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], f"lib{name}.so")


def _build(name: str, out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, os.path.join(_SRC_DIR, f"{name}.cpp")],
                   check=True, capture_output=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def get_library(name: str = "cc_label"):
    """The ctypes library ``name`` ("cc_label" or "tiff_codec"), built first
    if needed; None if it cannot be."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        _LIBS[name] = None
        try:
            # hashing the source raises FileNotFoundError (an OSError) in an
            # installed copy that lacks it: the Python engine takes over then
            out = library_path(name)
            if not os.path.exists(out):
                _build(name, out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError):
            return None
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
        return lib


def native_available(name: str = "cc_label") -> bool:
    return get_library(name) is not None
