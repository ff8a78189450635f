"""stream.entry_idle_share: the seconds of the traced window in which nothing
ran on the card while the innermost open program span was the stage-2
entry's (``stream.run_inference``: a brain's set-up, output memmaps, sizing
and flushes; ``stream.build_model``: the model's build from the weights), as
a share of the window."""

from benchlib.spans import ENTRY, idle_share

LAYER = "stream"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    return idle_share(record, ENTRY)
