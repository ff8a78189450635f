"""stream.wait_share: the union of the program's ``stream.slab_wait`` (the
compute thread blocked on the slab loader) and ``stream.writer_wait`` (blocked
on the chunk writer) spans, as a share of the traced window, busy device or
not."""

from benchlib.spans import WAITS, span_share

LAYER = "stream"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    return span_share(record, WAITS)
