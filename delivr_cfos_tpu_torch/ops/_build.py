"""Build the port's CUDA kernels from ``csrc/*.cu`` and load them with ctypes.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, no ninja), at first use, into
``<repo>/build/kernels/<hash>/`` where the hash covers the source and the
flags; a changed source builds anew, an unchanged one loads the library
already there. Pointers and the stream pass as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], f"lib{name}.so")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, float]:
    """Build every ``csrc/*.cu`` with one nvcc each, all started together.
    Returns seconds per source (0.0 where the library was already built)."""
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    seconds = {}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
        seconds[n] = time.perf_counter() - t0 if job is not None else 0.0
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
