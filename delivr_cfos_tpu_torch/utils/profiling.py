"""Profiler integration: the port's counterpart of
``delivr_cfos_tpu/utils/profiling.py``, on ``torch.profiler``.

The reference only has wall-clock prints (SURVEY.md §5.1); here a trace of
the whole run is a switch: set ``$DELIVR_TRACE_DIR`` (the JAX package's
switch) and ``trace()`` writes a Chrome trace (chrome://tracing, Perfetto)
of the host's operators and, where there is a card, its kernels into that
directory.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


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
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    )


def annotate(name: str):
    """Named region in profiler timelines (``record_function``)."""
    return torch.profiler.record_function(name)
