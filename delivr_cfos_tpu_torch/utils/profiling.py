"""Profiler integration: the port's counterpart of
``delivr_cfos_tpu/utils/profiling.py``, on ``torch.profiler``.

The reference only has wall-clock prints (SURVEY.md §5.1); here a trace of
the whole run is a switch: set ``$DELIVR_TRACE_DIR`` (the JAX package's
switch) and ``trace()`` writes a Chrome trace (chrome://tracing, Perfetto)
of the host's operators and, where there is a card, its kernels into that
directory.

Inside the program, ``annotate`` spans and ``count`` counters mark its
layers on the same timeline as the device's work. Both act only while a
profiler records on the calling thread (``trace()``, or any
``torch.profiler.profile`` around the call); otherwise each costs one
boolean check. The streaming engine's loader and writer threads record
nothing: their effect shows as the compute thread's wait spans.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext

import torch
from torch.autograd import _profiler_enabled

_OFF = nullcontext()
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()


@contextmanager
def trace(trace_dir: str | None = None):
    """Capture a torch.profiler trace around a block, written as
    ``{trace_dir}/trace_{pid}_{unix seconds}.json``. Enabled when
    ``trace_dir`` (or $DELIVR_TRACE_DIR) is set; no-op otherwise."""
    trace_dir = trace_dir or os.environ.get("DELIVR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    take_counters()  # a session reads only its own counts
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    )


def annotate(name: str):
    """Named region in profiler timelines (``record_function``) while a
    profiler records on this thread; a shared no-op context otherwise."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, while a profiler records on this
    thread; nothing otherwise."""
    if not _profiler_enabled():
        return
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def read_counters() -> dict[str, int]:
    """The counts kept since the last ``take_counters`` (or since ``trace()``
    began), left as they are."""
    with _counts_lock:
        return dict(_counts)


def take_counters() -> dict[str, int]:
    """The counts kept since the last call (or since ``trace()`` began),
    which are cleared."""
    with _counts_lock:
        out = dict(_counts)
        _counts.clear()
    return out
