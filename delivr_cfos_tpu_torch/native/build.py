"""Build the native connected-components library (g++ → shared object) at
first use, and load it with ctypes.

The library compiles from ``native/cc_label.cpp`` into
``<repo>/build/native/<hash>/`` (the hash covers the source and the flags),
not beside the sources: a changed source builds anew, an unchanged one loads
the library already there. It has a plain C interface, so no Python headers
are needed. Where g++ is missing or the build fails, ``get_library`` returns
None and the callers take the scipy engine, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cc_label.cpp")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_SRC))), "build", "native"
)
# no -march=native: the library may be loaded on another host than it was
# built on (a copy of the checkout with its build directory)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> str:
    """Where the library built from ``cc_label.cpp`` lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], "libcc_label.so")


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True,
                   capture_output=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def get_library():
    """The ctypes library, built first if needed; None if it cannot be."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            # hashing the source raises FileNotFoundError (an OSError) in an
            # installed copy that lacks cc_label.cpp: scipy takes over then
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.cc_label_u8.restype = ctypes.c_int64
        lib.cc_label_u8.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        lib.cc_statistics_i32.restype = None
        lib.cc_statistics_i32.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 4 + [
            ctypes.c_void_p] * 3
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_library() is not None
