"""model.attended_share: the sample-windows × heads that the program's window
attention took in the traced window (its ``model.window_heads_attended``
counter, padded windows included) over those that the inputs need (the
forwards, counted by the benchmark from the phantom, times the window-heads
of one forward by the model module's ``window_attention_shapes``). A sound
program reads 100 exactly: above is work the inputs do not need, below a
window or a head lost."""

from benchlib import cells
from benchlib.window_attention import window_heads

LAYER = "model"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    try:
        from delivr_cfos_tpu_torch.utils.profiling import read_counters
    except ImportError:  # a program without the counter's reader
        return None
    cfg = record["config"]
    shapes = getattr(cells.model_module(cfg), "window_attention_shapes", None)
    counted = read_counters().get("model.window_heads_attended")
    if shapes is None or counted is None or not record["forwards"]:
        return None
    return 100.0 * counted / (record["forwards"] * window_heads(shapes(cfg)))
