"""stream.peak_gib: torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats(): the device memory that the streaming
engine's slab and window-batch sizing spends for throughput."""

LAYER = "stream"
UNIT = "GiB"
MOVES = "gvox_per_s"


def read(record):
    if record["peak_bytes"] is None:
        return None
    return record["peak_bytes"] / 2**30
