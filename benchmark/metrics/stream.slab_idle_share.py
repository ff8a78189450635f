"""stream.slab_idle_share: the seconds of the traced window in which nothing
ran on the card while the innermost open program span was the streaming
engine's slab loop (``stream.slab``, ``stream.slab_wait``,
``stream.finalize``, ``stream.writer_wait``), as a share of the window."""

from benchlib.spans import SLAB, idle_share

LAYER = "stream"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    return idle_share(record, SLAB)
