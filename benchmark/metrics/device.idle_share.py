"""device.idle_share: the share of the traced window in which nothing ran on
the card: 1 − (union of kernel, memcpy and memset intervals) / window."""

LAYER = "device"
UNIT = "%"
MOVES = "gvox_per_s"


def read(record):
    window, busy = record["window_s"], record["busy_s"]
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
