"""The readers of the program's spans and counter, on hand-made records: the
device's idle time split by the innermost program span, the union of the
wait spans, and the forwarded windows against the phantom's count.

    python3 -m pytest benchmark/tests/test_bench_spans.py -q
"""

import numpy as np
import pytest
import torch

import tiny  # noqa: F401 (puts the benchmark and the program on the path)

from benchlib import cells
from benchlib.spans import PROGRAM_SPANS, idle_by_span
from benchlib.trace import union_seconds

SPAN_METRICS = ("stream.entry_idle_share", "stream.slab_idle_share", "model.idle_share")
NEW = SPAN_METRICS + ("stream.wait_share", "model.forwarded_share")

# one brain in a window of [0, 1000) ns, the program's spans nested as the
# compute thread opens them, beside the harness's own spans and host ops
HOST = [
    ("bench.window", 0, 1000),
    ("bench.volume", 20, 990),
    ("stream.run_inference", 50, 950),
    ("stream.build_model", 60, 160),
    ("aten::uniform_", 70, 150),
    ("stream.slab", 200, 700),
    ("stream.slab_wait", 200, 260),
    ("model.accumulate", 270, 600),
    ("model.background_test", 270, 300),
    ("aten::amax", 275, 285),
    ("model.forward_batch", 300, 450),
    ("model.forward_batch", 450, 590),
    ("stream.finalize", 610, 680),
    ("stream.writer_wait", 685, 695),
    ("stream.writer_wait", 720, 800),
]
# busy [0, 10) [100, 140) [250, 320) [350, 360) [500, 640) [700, 760)
# [990, 1000): idle 660 of 1000 ns, in ns by the innermost span:
#   run_inference [50, 60) [160, 200) [800, 950); build_model [60, 100)
#   [140, 160); slab_wait [200, 250); finalize [640, 680); slab [680, 685)
#   [695, 700); writer_wait [685, 695) [760, 800); forward_batch [320, 350)
#   [360, 450) [450, 500); none (the harness) [10, 50) [950, 990)
DEVICE = [(0, 10), (100, 130), (120, 140), (250, 320), (350, 360), (500, 640),
          (700, 760), (990, 1000), (1000, 1100)]
WANT_NS = {"stream.run_inference": 200, "stream.build_model": 60, "stream.slab_wait": 50,
           "stream.finalize": 40, "stream.slab": 10, "stream.writer_wait": 50,
           "model.forward_batch": 170, None: 80}


def _record(host=HOST, device=DEVICE, window=(0, 1000)):
    names, s, e = zip(*host) if host else ((), (), ())
    d = np.array(device, np.int64).reshape(-1, 2)
    trace = {
        "window": window,
        "device": {"name": ["k"] * len(d), "start": d[:, 0], "end": d[:, 1]},
        "host": {"name": list(names), "start": np.array(s, np.int64),
                 "end": np.array(e, np.int64)},
    }
    window_s = (window[1] - window[0]) / 1e9
    busy = union_seconds(trace) if len(d) else 0.0
    return {"trace": trace, "window_s": window_s, "busy_s": busy, "forwards": 390,
            "config": {}, "volumes": 1, "passes": 13, "peak_bytes": None,
            "program_kernels": []}


def _read(metric, record):
    return cells.metric_reader(metric).read(record)


def _oracle(record):
    """Idle ns by innermost program span, one ns at a time."""
    tr = record["trace"]
    lo, hi = tr["window"]
    dev = list(zip(tr["device"]["start"], tr["device"]["end"]))
    spans = [(s, e, n) for n, s, e in zip(tr["host"]["name"], tr["host"]["start"],
                                           tr["host"]["end"]) if n in PROGRAM_SPANS]
    out = {}
    for t in range(lo, hi):
        if any(s <= t < e for s, e in dev):
            continue
        cover = [(s, -e, n) for s, e, n in spans if s <= t < e]
        name = max(cover)[2] if cover else None
        out[name] = out.get(name, 0) + 1
    return out


def test_idle_split_by_hand():
    got = idle_by_span(_record()["trace"])
    assert {k: round(v * 1e9) for k, v in got.items() if v} == WANT_NS
    assert WANT_NS == _oracle(_record())


def test_readers_by_hand():
    r = _record()
    share = {m: _read(m, r) for m in SPAN_METRICS}
    assert share["stream.entry_idle_share"] == pytest.approx(26.0)
    assert share["stream.slab_idle_share"] == pytest.approx(15.0)
    assert share["model.idle_share"] == pytest.approx(17.0)
    # waits: [200, 260) [685, 695) [720, 800)
    assert _read("stream.wait_share", r) == pytest.approx(15.0)
    # the three and the harness's remainder (8 %) are the device's idle share
    total = sum(share.values()) + 8.0
    assert total == pytest.approx(_read("device.idle_share", r))


@pytest.mark.parametrize("seed", range(6))
def test_idle_split_against_the_oracle(seed):
    """Random nested spans and device intervals: the split equals a count
    of idle ns under each innermost span, and the parts add up to
    device.idle_share."""
    rng = np.random.default_rng(seed)
    host = [("bench.window", 0, 600)]

    def nest(lo, hi, depth):
        t = lo
        while t < hi - 4 and depth < 4:
            a = int(rng.integers(t, hi - 2))
            b = int(rng.integers(a + 1, min(hi, a + 120) + 1))
            host.append((str(rng.choice(PROGRAM_SPANS)), a, b))
            if rng.random() < 0.6:
                nest(a, b, depth + 1)
            t = b + int(rng.integers(0, 30))

    nest(0, 600, 0)
    starts = np.sort(rng.integers(-20, 620, 40))
    device = [(int(s), int(s + rng.integers(1, 25))) for s in starts]
    r = _record(host, device, window=(0, 600))
    got = {k: round(v * 1e9) for k, v in idle_by_span(r["trace"]).items() if v}
    assert got == _oracle(r)
    parts = sum(_read(m, r) for m in SPAN_METRICS)
    rest = 100.0 * got.get(None, 0) / 600
    assert parts + rest == pytest.approx(_read("device.idle_share", r))


def test_nothing_to_read_gives_none():
    from delivr_cfos_tpu_torch.utils.profiling import take_counters

    take_counters()
    no_device = _record(device=[])
    no_spans = _record(host=[h for h in HOST if h[0] not in PROGRAM_SPANS])
    for metric in NEW:
        assert _read(metric, no_device) is None, metric
    for metric in NEW:  # a program without spans or counters, as a parent's
        assert _read(metric, no_spans) is None, metric
    assert idle_by_span(no_spans["trace"]) is None


def test_forwarded_share_reads_the_counter():
    from delivr_cfos_tpu_torch.utils import profiling

    profiling.take_counters()
    r = _record()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("model.windows_forwarded", 130)
        profiling.count("model.windows_forwarded", 260)
    assert _read("model.forwarded_share", r) == 100.0
    assert _read("model.forwarded_share", r) is None  # taken: read once
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("model.windows_forwarded", 400)
    assert _read("model.forwarded_share", r) == pytest.approx(100.0 * 400 / 390)
    profiling.count("model.windows_forwarded", 390)  # no profile: not kept
    assert _read("model.forwarded_share", r) is None
