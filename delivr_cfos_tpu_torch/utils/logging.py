"""Timestamped logging and structured per-stage timing (the port's copy of
``delivr_cfos_tpu/utils/logging.py``).

The reference logs ``{datetime.now()} : message`` lines and measures stages
with ad-hoc wall-clock deltas (SURVEY.md §5.1). The line format stays; a
structured ``StageTimer`` can be dumped as JSON for profiling and regression
tracking.
"""

from __future__ import annotations

import datetime
import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


def log(*parts: object) -> None:
    """Print a '{timestamp} : message' line, matching the reference format."""
    msg = " ".join(str(p) for p in parts)
    print(f"{datetime.datetime.now()} : {msg}", flush=True)


@dataclass
class StageTimer:
    """Collects named wall-clock spans; nested spans are dotted paths."""

    spans: dict = field(default_factory=dict)
    _prefix: str = ""

    @contextmanager
    def span(self, name: str):
        full = f"{self._prefix}{name}"
        old_prefix = self._prefix
        self._prefix = full + "."
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._prefix = old_prefix
            dt = time.perf_counter() - t0
            self.spans[full] = self.spans.get(full, 0.0) + dt
            log(f"[timing] {full}: {dt:.3f}s")

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.spans, f, indent=2, sort_keys=True)
