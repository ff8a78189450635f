"""SWC point-file I/O matching the reference's exchange format.

The port's counterpart of ``delivr_cfos_tpu/registration/swc.py``, without
pandas. The reference writes cell centroids as SWC files for mBrainAligner's
``swc_registration`` (reference: automate_mBrainaligner.py:75-197): header
line ``##n type x y z radius parent``, space-separated rows where the row
number is the cell number, ``type`` = 1, ``radius`` carries the blob Size,
and ``parent`` = −1.

A frame here is a dict of equal-length numpy columns; its rows are numbered
from 0, as the JAX package's DataFrame index is. ``write_rows`` gives the
bytes of pandas' ``DataFrame.to_csv``: an integer as ``str``, a float as
``repr`` of the Python float (shortest round trip, ``-0.0`` kept), NaN as
the empty string.
"""

from __future__ import annotations

import numpy as np

SWC_HEADER = "##n type x y z radius parent\n"
SWC_COLUMNS = ("Structure", "x", "y", "z", "Size", "Parent")


def _text(column: np.ndarray) -> list:
    """Each value of ``column`` as pandas' ``to_csv`` writes it."""
    if column.dtype.kind == "f":
        return ["" if v != v else repr(v) for v in column.astype(np.float64).tolist()]
    return [str(v) for v in column.tolist()]


def write_rows(f, columns, sep: str = " ") -> None:
    """Write the rows of ``columns`` (a sequence of equal-length arrays)."""
    texts = [_text(np.asarray(c)) for c in columns]
    f.write("".join(sep.join(row) + "\n" for row in zip(*texts)))


def write_swc(path: str, frame: dict) -> None:
    """``frame`` columns: Structure, x, y, z, Size, Parent; the row number is
    the cell number (reference: automate_mBrainaligner.py:135-144,188-196)."""
    n = len(frame["x"])
    with open(path, "w") as f:
        f.write(SWC_HEADER)
        write_rows(f, [np.arange(n)] + [frame[k] for k in SWC_COLUMNS])


def read_swc(path: str, skiprows: int = 1) -> dict:
    """Reads an SWC into columns n, type, x, y, z, radius, parent
    (reference: automate_mBrainaligner.py:242-244): a column of integers is
    int64, any other float64, as pandas infers them."""
    with open(path) as f:
        rows = [line.split(" ") for line in f.read().splitlines()[skiprows:] if line]
    names = ("n", "type", "x", "y", "z", "radius", "parent")
    out = {}
    for k, name in enumerate(names):
        tokens = [r[k] for r in rows]
        try:
            out[name] = np.array([int(t) for t in tokens], np.int64)
        except ValueError:
            out[name] = np.array([float(t) for t in tokens], np.float64)
    return out


def swc_frame_from_cells(x, y, z, size) -> dict:
    """The reference's SWC-conform frame: Structure=1, coords rounded to 3
    digits, Size in the radius column, Parent=−1
    (automate_mBrainaligner.py:121-144)."""
    size = np.asarray(size)
    n = len(size)
    return {
        "Structure": np.ones(n, np.int64),
        "x": np.round(np.asarray(x, np.float64), 3),
        "y": np.round(np.asarray(y, np.float64), 3),
        "z": np.round(np.asarray(z, np.float64), 3),
        "Size": size,
        "Parent": np.full(n, -1, np.int64),
    }
