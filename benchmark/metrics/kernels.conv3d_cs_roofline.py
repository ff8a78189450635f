"""kernels.conv3d_cs_roofline: the least time of the 3×3×3 convs that the
model runs on ``conv3d_cs`` (the larger of operations at the bf16 peak and
bytes at the HBM peak, each input byte read once, each output written once,
the weights once a pass over a volume), at the shapes that the model
module names (``conv3d_cs_shapes``) times the windows forwarded, over the
device time (union) of every kernel whose name holds "conv3d_cs", the input
staging (pack) included. The work is counted from the model, not from
launches."""

from benchlib import cells
from benchlib.arith import convs_bound_s
from benchlib.trace import union_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    if not record["forwards"]:
        return None
    spent = union_seconds(record["trace"], lambda name: "conv3d_cs" in name)
    if spent <= 0:
        return None
    cfg = record["config"]
    least = convs_bound_s(cells.model_module(cfg).conv3d_cs_shapes(cfg), record["forwards"],
                          weight_reads=record["volumes"] * record["passes"])
    return 100.0 * least / spent
