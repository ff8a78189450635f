"""The program's own spans in a reduced trace (``benchlib/trace.py::collect``):
the device's idle time split by the innermost program span open on the
host, and the union of chosen spans.

The program opens its spans (``utils/profiling.py::annotate``) on the
compute thread alone, so they nest; a stretch of the window is under the
latest-starting of the spans that cover it. Idle time under no program span
is the harness's own loop between brains. A trace without the program's
spans (a program that has none) or without device events gives None.
"""

from __future__ import annotations

import numpy as np

from benchlib.trace import merge

ENTRY = ("stream.run_inference", "stream.build_model")
SLAB = ("stream.slab", "stream.slab_wait", "stream.finalize", "stream.writer_wait")
MODEL = ("model.accumulate", "model.background_test", "model.forward_batch")
PROGRAM_SPANS = ENTRY + SLAB + MODEL
WAITS = ("stream.slab_wait", "stream.writer_wait")


def _spans(trace: dict, names) -> tuple[list, np.ndarray, np.ndarray]:
    host = trace["host"]
    pick = np.array([n in names for n in host["name"]], bool)
    picked = [n for n, p in zip(host["name"], pick) if p]
    return picked, host["start"][pick], host["end"][pick]


def idle_by_span(trace: dict) -> dict | None:
    """Seconds of the window with nothing on the device, by the innermost
    open program span's name; under the key None, those under no program
    span. None where the trace holds no device event or no program span."""
    dev = trace["device"]
    names, s, e = _spans(trace, PROGRAM_SPANS)
    if not dev["start"].size or not names:
        return None
    lo, hi = trace["window"]
    # an empty interval at lo heads the busy ones, so each t >= lo has one
    # that starts by it
    busy = np.concatenate([[[lo, lo]], merge(dev["start"], dev["end"], lo, hi)])
    before = np.cumsum(busy[:, 1] - busy[:, 0])

    def idle_before(t: np.ndarray) -> np.ndarray:
        # busy time in [lo, t): the intervals that start by t, less the
        # part of the last of them that runs past t
        k = np.searchsorted(busy[:, 0], t, side="right") - 1
        return (t - lo) - (before[k] - np.clip(busy[k, 1] - t, 0, None))

    s, e = np.clip(s, lo, hi), np.clip(e, lo, hi)
    edges = np.unique(np.concatenate([[lo, hi], s, e]))
    idle = np.diff(idle_before(edges))
    out: dict = {None: 0.0}
    for a, b, ns in zip(edges[:-1], edges[1:], idle):
        if ns <= 0:
            continue
        cover = np.nonzero((s <= a) & (e >= b))[0]
        name = None
        if cover.size:
            # the latest start; of spans that start together, the shortest
            inner = cover[np.lexsort((e[cover], -s[cover]))[0]]
            name = names[inner]
        out[name] = out.get(name, 0.0) + float(ns) / 1e9
    return out


def idle_share(record: dict, names) -> float | None:
    """The idle seconds under the spans ``names`` as a % of the window."""
    if record["busy_s"] <= 0:
        return None
    idle = idle_by_span(record["trace"])
    if idle is None:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / record["window_s"]


def span_share(record: dict, names) -> float | None:
    """The union of the spans ``names`` as a % of the window; None where
    the trace holds no device event or no program span."""
    trace = record["trace"]
    if record["busy_s"] <= 0 or not _spans(trace, PROGRAM_SPANS)[0]:
        return None
    _, s, e = _spans(trace, names)
    lo, hi = trace["window"]
    m = merge(s, e, lo, hi)
    return 100.0 * float((m[:, 1] - m[:, 0]).sum()) / 1e9 / record["window_s"]
