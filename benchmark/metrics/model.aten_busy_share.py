"""model.aten_busy_share: the device time of everything not launched from
the program's own CUDA sources (its csrc/*.cu kernels): PyTorch's
elementwise epilogues, casts, copies, gathers and the accumulation, as a
share of the device's busy time (unions of intervals, both)."""

from benchlib.trace import union_seconds

LAYER = "model"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    if record["busy_s"] <= 0:
        return None
    own = tuple(record["program_kernels"])
    other = union_seconds(record["trace"], lambda name: not any(k in name for k in own))
    return 100.0 * other / record["busy_s"]
