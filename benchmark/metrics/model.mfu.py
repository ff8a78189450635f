"""model.mfu: the forward's operations that the inputs need (the windows
that pass the background test, counted by the benchmark from the phantom,
times the passes, times one window's operations as the model module that
the configuration names counts them) over the traced window's seconds, as
a share of the H100's dense bf16 peak."""

from benchlib import cells
from benchlib.arith import PEAK_BF16_FLOPS

LAYER = "model"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    if record["busy_s"] <= 0 or not record["forwards"]:
        return None
    cfg = record["config"]
    flops = record["forwards"] * cells.model_module(cfg).forward_flops(cfg)["total"]
    return 100.0 * flops / record["window_s"] / PEAK_BF16_FLOPS
