"""kernels.window_attention_roofline: the least time of the window attention
that the model needs (``benchlib/window_attention.py``: per attention call
the larger of its QKᵀ and PV operations at the bf16 peak and its bytes at
the HBM peak, q, k and v read once, the output written once, each call's
bias table once a pass over a volume), at the shapes that the model module
names (``window_attention_shapes``) times the windows forwarded, over the
device time (union) of every kernel whose name holds "window_attention_cs".
The work is counted from the model, not from launches."""

from benchlib import cells
from benchlib.trace import union_seconds
from benchlib.window_attention import attention_bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    cfg = record["config"]
    shapes = getattr(cells.model_module(cfg), "window_attention_shapes", None)
    if shapes is None or not record["forwards"]:
        return None
    spent = union_seconds(record["trace"], lambda name: "window_attention_cs" in name)
    if spent <= 0:
        return None
    least = attention_bound_s(shapes(cfg), record["forwards"],
                              bias_reads=record["volumes"] * record["passes"])
    return 100.0 * least / spent
