"""model.forwarded_share: the windows × passes that the program sent through
the UNet in the traced window (its ``model.windows_forwarded`` counter) over
those that the inputs need (the windows that pass the background test,
counted by the benchmark from the phantom, times the passes, times the
brains). A sound program reads 100 exactly: above is work the inputs do not
need, below a window lost."""

LAYER = "model"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    try:
        from delivr_cfos_tpu_torch.utils.profiling import take_counters
    except ImportError:  # a program without counters
        return None
    counted = take_counters().get("model.windows_forwarded")
    if record["busy_s"] <= 0 or not record["forwards"] or counted is None:
        return None
    return 100.0 * counted / record["forwards"]
