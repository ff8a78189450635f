"""HOOK stdout progress protocol, consumed by the DELiVR Fiji plugin (the
port's copy of ``delivr_cfos_tpu/utils/hooks.py``).

The reference emits two line formats on stdout (reference: __main__.py:85,96):

    HOOK:OVERALL:{n_stages}
    HOOK:{stage_index}:{n_stages}:{item_index}:{n_items}

``stage_index`` is 1-based over the *enabled* stages; ``item_index`` is
0-based over the work items (brains) within a stage, matching the
reference's ``enumerate`` counters (reference: __main__.py:96). The format
must be preserved verbatim for Fiji-plugin compatibility (SURVEY.md §5.5).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import TextIO


@dataclass
class HookEmitter:
    """Emits HOOK protocol lines; one instance per pipeline run."""

    n_stages: int
    stream: TextIO = field(default_factory=lambda: sys.stdout)
    _stage: int = 0

    def overall(self) -> None:
        """Announce the total number of enabled stages (HOOK:OVERALL:n)."""
        print(f"HOOK:OVERALL:{self.n_stages}", file=self.stream, flush=True)

    def begin_stage(self) -> int:
        """Advance to the next stage; returns the 1-based stage index."""
        self._stage += 1
        return self._stage

    def item(self, item_index: int, n_items: int) -> None:
        """Report progress on work item ``item_index`` (0-based) of ``n_items``."""
        print(
            f"HOOK:{self._stage}:{self.n_stages}:{item_index}:{n_items}",
            file=self.stream,
            flush=True,
        )

    @property
    def stage(self) -> int:
        return self._stage
