"""model.swin_idle_share: the seconds of the traced window in which nothing
ran on the card while the program's ``model.swin_encoder`` span was open
(SwinUNETR's patch embed, four stages and hidden-state norms: the host
launching the encoder's many small PyTorch ops), as a share of the window.
Whatever program span lies outside or inside it, the time counts here once."""

import numpy as np

from benchlib.spans import _spans
from benchlib.trace import merge

LAYER = "model"
UNIT = "%"
MOVES = "gvox_per_s"
SPAN = ("model.swin_encoder",)


def read(record):
    trace = record["trace"]
    _, s, e = _spans(trace, SPAN)
    if record["busy_s"] <= 0 or not s.size:
        return None
    lo, hi = trace["window"]
    spans = merge(s, e, lo, hi)
    busy = np.concatenate([[[lo, lo]], merge(trace["device"]["start"], trace["device"]["end"],
                                             lo, hi)])
    before = np.cumsum(busy[:, 1] - busy[:, 0])

    def busy_before(t):
        # busy time in [lo, t): the intervals that start by t, less the part
        # of the last of them that runs past t
        k = np.searchsorted(busy[:, 0], t, side="right") - 1
        return before[k] - np.clip(busy[k, 1] - t, 0, None)

    inside = busy_before(spans[:, 1]) - busy_before(spans[:, 0])
    idle = float(((spans[:, 1] - spans[:, 0]) - inside).sum()) / 1e9
    return 100.0 * idle / record["window_s"]
