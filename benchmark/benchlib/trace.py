"""Reduction of a ``torch.profiler`` trace to device intervals, busy time as
the union of those intervals, and the breakdown of where the time went.

Busy time is the union of every kernel, memcpy and memset interval on the
device timeline, so that work on the streaming engine's copy streams that
overlaps the compute stream counts once, and copies count at all.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

WINDOW_SPAN = "bench.window"
VOLUME_SPAN = "bench.volume"


def collect(prof) -> dict:
    """Device and host events of a finished profile: names and
    [start, end) in ns, and the bounds of the ``bench.window`` span."""
    dev_n, dev_s, dev_e, cpu_n, cpu_s, cpu_e = [], [], [], [], [], []
    window = None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # spans of record_function are mirrored on the device timeline
            # as user annotations: they are not device work
            if ev.name().startswith("bench.") or _is_annotation(ev):
                continue
            dev_n.append(ev.name())
            dev_s.append(s)
            dev_e.append(e)
        else:
            if ev.name() == WINDOW_SPAN:
                window = (s, e)
            cpu_n.append(ev.name())
            cpu_s.append(s)
            cpu_e.append(e)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    return {
        "window": window,
        "device": {"name": dev_n, "start": np.array(dev_s, np.int64),
                   "end": np.array(dev_e, np.int64)},
        "host": {"name": cpu_n, "start": np.array(cpu_s, np.int64),
                 "end": np.array(cpu_e, np.int64)},
    }


def _is_annotation(ev) -> bool:
    test = getattr(ev, "is_user_annotation", None)
    if test is not None and test():
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def merge(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The union of intervals clipped to [lo, hi), as sorted disjoint
    (start, end) rows."""
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if not s.size:
        return np.zeros((0, 2), np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    ends_of = np.append(idx[1:] - 1, s.size - 1)
    return np.stack([s[idx], run_end[ends_of]], axis=1)


def union_seconds(trace: dict, select=None) -> float:
    """Seconds of the window in which a device interval ran, of all of them
    or of those whose name ``select(name)`` accepts."""
    dev = trace["device"]
    lo, hi = trace["window"]
    if select is None:
        s, e = dev["start"], dev["end"]
    else:
        pick = np.array([bool(select(n)) for n in dev["name"]], bool)
        if not pick.any():
            return 0.0
        s, e = dev["start"][pick], dev["end"][pick]
    m = merge(s, e, lo, hi)
    return float((m[:, 1] - m[:, 0]).sum()) / 1e9


def device_ops(trace: dict, top: int = 10) -> list:
    """The device operations that took most time in the window, summed by
    name: [[name, seconds], ...]."""
    dev = trace["device"]
    lo, hi = trace["window"]
    dur = np.clip(dev["end"], lo, hi) - np.clip(dev["start"], lo, hi)
    totals: dict[str, int] = {}
    for name, d in zip(dev["name"], dur):
        if d > 0:
            totals[name] = totals.get(name, 0) + int(d)
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], ns / 1e9] for name, ns in rows]


def idle_gaps(trace: dict, top: int = 10) -> list:
    """The longest stretches of the window with nothing on the device, each
    named by the host activity that overlaps it most (the innermost such
    op, leaving out the benchmark's own spans): [[name, seconds], ...]."""
    dev, host = trace["device"], trace["host"]
    lo, hi = trace["window"]
    m = merge(dev["start"], dev["end"], lo, hi)
    edges = np.concatenate([[lo], m.ravel(), [hi]]).reshape(-1, 2)
    length = edges[:, 1] - edges[:, 0]
    order = np.argsort(-length)[:top]
    own = np.array([n.startswith("bench.") for n in host["name"]], bool)
    hs, he = host["start"][~own], host["end"][~own]
    names = [n for n, o in zip(host["name"], own) if not o]
    rows = []
    for i in order:
        g0, g1 = edges[i]
        if g1 <= g0:
            continue
        over = np.minimum(he, g1) - np.maximum(hs, g0)
        name = "no host op"
        if over.size and over.max() > 0:
            best = over >= 0.99 * over.max()
            cand = np.nonzero(best)[0]
            name = names[int(cand[np.argmin((he - hs)[cand])])]
        rows.append([f"{name[:150]} (host)", float(g1 - g0) / 1e9])
    return rows


def program_kernel_names(package_dir: str) -> list[str]:
    """The names of the ``__global__`` kernels of the program's CUDA
    sources, ``<package>/csrc/*.cu``."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    names = []
    for path in sorted(glob.glob(os.path.join(package_dir, "csrc", "*.cu"))):
        with open(path) as f:
            names += pattern.findall(f.read())
    return names
