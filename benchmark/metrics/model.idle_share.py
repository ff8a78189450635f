"""model.idle_share: the seconds of the traced window in which nothing ran on
the card while the innermost open program span was the sliding-window
engine's (``model.accumulate``: the grid, skips and overlap adds;
``model.background_test``: the per-window max and its host sync;
``model.forward_batch``: a window batch's gather, noise, flips and UNet
launches), as a share of the window."""

from benchlib.spans import MODEL, idle_share

LAYER = "model"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    return idle_share(record, MODEL)
