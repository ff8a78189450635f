""".npy memmap helpers matching the reference's on-disk conventions.

The reference stores whole-brain intermediates as memmapped .npy files and
re-opens them with ``np.memmap(..., offset=128)`` to skip the .npy header
(reference: count_blobs.py:46, inference/inference.py:234). A v1.0 .npy
header for these shapes is exactly 128 bytes, so that invariant is pinned at
write time (``open_memmap`` asserts it) and the constant is exposed for readers.
"""

from __future__ import annotations

import os

import numpy as np

NPY_HEADER_BYTES = 128


def open_memmap(path: str, shape, dtype, mode: str = "w+") -> np.memmap:
    """Create/open a .npy memmap; on creation verifies the 128-byte header
    invariant that downstream offset-based readers rely on."""
    if mode in ("w+",):
        if os.path.exists(path):
            os.remove(path)
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.dtype(dtype), shape=tuple(shape))
        if mm.offset != NPY_HEADER_BYTES:  # type: ignore[attr-defined]
            raise AssertionError(
                f"{path}: .npy header is {mm.offset} bytes, expected {NPY_HEADER_BYTES}"
            )
        return mm
    return np.lib.format.open_memmap(path, mode=mode)


def memmap_raw(path: str, shape, dtype, mode: str = "r") -> np.memmap:
    """Reference-style raw open skipping the .npy header
    (``np.memmap(path, offset=128)``, reference: count_blobs.py:46)."""
    return np.memmap(
        path, dtype=np.dtype(dtype), mode=mode, offset=NPY_HEADER_BYTES, shape=tuple(shape)
    )
