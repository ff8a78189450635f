"""The port's spans and counter inside stage 2 (``utils/profiling.py``'s
``annotate`` and ``count``), on the CPU.

Under a ``torch.profiler`` profile each span of the streaming engine, the
sliding-window engine and the stage-2 entry appears on the compute thread,
nested as the layers are, once per slab or window batch, with the aten ops
it encloses inside its bounds; the counter reads the windows × passes sent
through the UNet. Without a profile no ``record_function`` is entered and
nothing is counted, and the outputs are the same bits either way."""

import os

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.engine import streaming as st
from delivr_cfos_tpu_torch.engine.sliding_window import (
    SlidingWindowConfig,
    dense_patch_starts,
)
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference
from delivr_cfos_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
ROI = (16, 16, 16)
MODEL_CFG = BasicUNetConfig(features=TINY)
SHAPE = (40, 24, 24)  # 4 window rows: 2 slabs of 2 rows
SLAB_ROWS = 2
BATCH = 4
PASSES = 13

STREAM_SPANS = ("stream.slab", "stream.slab_wait", "stream.finalize", "stream.writer_wait")
MODEL_SPANS = ("model.accumulate", "model.background_test", "model.forward_batch")


@pytest.fixture(scope="module")
def model():
    sd = init_state_dict(MODEL_CFG, torch.Generator().manual_seed(7))
    return build_model(sd, MODEL_CFG, "cpu"), sd


def _volume(shape=SHAPE, seed=3):
    """Tissue in the low-y half, zeros elsewhere: some windows are
    background."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint16)
    vol[:, : shape[1] // 2 - 2] = (rng.random((shape[0], shape[1] // 2 - 2, shape[2]))
                                   * 700 + 1).astype(np.uint16)
    return vol


def _cfg(tta=True):
    return SlidingWindowConfig(roi=ROI, batch_size=BATCH, tta=tta, erosion_iters=2)


def _stream(model, vol, tta=True, prefetch=True):
    logits = np.full(vol.shape, np.nan, np.float32)
    bins, _ = st.infer_volume_streaming(model, vol, _cfg(tta), MODEL_CFG,
                                        slab_z_starts=SLAB_ROWS, logits_out=logits,
                                        prefetch=prefetch)
    return bins, logits


def _active(vol, z_rows=None):
    """Windows of the grid whose plain max is above 0 (of the window rows
    ``z_rows`` alone, when given)."""
    starts = dense_patch_starts(vol.shape, ROI, 0.5)
    if z_rows is not None:
        starts = starts[np.isin(starts[:, 0], z_rows)]
    return sum(int(vol[z:z + ROI[0], y:y + ROI[1], x:x + ROI[2]].max() > 0)
               for z, y, x in starts)


def _profile(fn):
    """Run ``fn`` under a CPU profile; returns {name: [(start, end), ...]} of
    the host events, in ns of one clock."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        events.setdefault(ev.name(), []).append((s, s + ev.duration_ns()))
    return events


def _inside(inner, outer):
    s, e = inner
    return any(s >= o0 and e <= o1 for o0, o1 in outer)


def test_streaming_spans_nest_and_count(model):
    m, _ = model
    vol = _volume()
    events = _profile(lambda: _stream(m, vol))
    z_rows = sorted({int(z) for z in dense_patch_starts(SHAPE, ROI, 0.5)[:, 0]})
    slabs = [z_rows[i:i + SLAB_ROWS] for i in range(0, len(z_rows), SLAB_ROWS)]
    n = len(slabs)
    assert n >= 2
    batches = sum(PASSES * -(-_active(vol, rows) // BATCH) for rows in slabs)
    want = {"stream.slab": n, "stream.slab_wait": n, "stream.finalize": n,
            "stream.writer_wait": n + 1, "model.accumulate": n,
            "model.background_test": n, "model.forward_batch": batches}
    assert {k: len(events.get(k, [])) for k in want} == want

    slab = events["stream.slab"]
    for name in ("stream.slab_wait", "stream.finalize", "model.accumulate"):
        assert all(_inside(iv, slab) for iv in events[name]), name
    # one writer join a chunk inside its slab, and the last one after them
    waits = sorted(events["stream.writer_wait"])
    assert all(_inside(iv, slab) for iv in waits[:-1])
    assert waits[-1][0] >= max(e for _, e in slab)
    for name in ("model.background_test", "model.forward_batch"):
        assert all(_inside(iv, events["model.accumulate"]) for iv in events[name]), name
    # the aten ops a span encloses lie inside its bounds: one clock
    for op, span in (("aten::amax", "model.background_test"),
                     ("aten::normal_", "model.forward_batch"),
                     ("aten::flip", "model.forward_batch"),
                     ("aten::sigmoid", "stream.finalize")):
        assert events.get(op), op
        assert all(_inside(iv, events[span]) for iv in events[op]), op


@pytest.mark.parametrize("load_all_ram", [False, True])
def test_entry_spans(model, tmp_path, load_all_ram):
    """``run_inference`` holds one brain's span, the model build inside it,
    and either branch's spans inside it."""
    _, sd = model
    vol = _volume()
    d = tmp_path / "in" / "brain" / "masked_niftis"
    os.makedirs(d)
    np.save(d / "masked_nifti.npy", vol[None, None])
    cfg = PipelineConfig.from_dict({
        "blob_detection": {
            "input_location": str(tmp_path / "in"),
            "output_location": str(tmp_path / "out"),
            "window_dimensions": {f"window_dim_{i}": 16 for i in range(3)},
            "erosion_iters": 2,
        },
        "FLAGS": {"ABSPATHS": True, "LOAD_ALL_RAM": load_all_ram},
    })
    events = _profile(lambda: run_inference(cfg, "brain", (1, 1, *SHAPE), params=sd,
                                            device="cpu"))
    (brain,) = events["stream.run_inference"]
    (build,) = events["stream.build_model"]
    assert _inside(build, [brain])
    inner = (STREAM_SPANS if not load_all_ram else ()) + MODEL_SPANS
    for name in inner:
        assert events.get(name) and all(_inside(iv, [brain]) for iv in events[name]), name
    if load_all_ram:
        assert not any(k in events for k in STREAM_SPANS)


def test_windows_forwarded_counter(model):
    m, _ = model
    vol = _volume()
    profiling.take_counters()
    _profile(lambda: _stream(m, vol))
    assert profiling.take_counters() == {"model.windows_forwarded": _active(vol) * PASSES}
    assert profiling.take_counters() == {}


def test_nothing_entered_without_a_profile(model, monkeypatch):
    m, _ = model
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    profiling.take_counters()
    _stream(m, _volume())
    assert calls == [] and profiling.take_counters() == {}
    _profile(lambda: _stream(m, _volume()))
    assert "stream.slab" in calls  # the patch sees the spans when they record


def test_traced_sessions_read_their_own_counts(model, tmp_path):
    m, _ = model
    a, b = _volume(seed=4), _volume((24, 40, 24), seed=5)
    with profiling.trace(str(tmp_path)):
        _stream(m, a, tta=False)
    with profiling.trace(str(tmp_path)):  # no take between: trace() clears
        _stream(m, b, tta=False)
    assert profiling.take_counters() == {"model.windows_forwarded": _active(b)}
    _profile(lambda: _stream(m, a, tta=False))
    assert profiling.take_counters() == {"model.windows_forwarded": _active(a)}
    assert len(os.listdir(tmp_path)) >= 1  # the Chrome traces


@pytest.mark.parametrize("prefetch", [True, False])
def test_outputs_equal_with_and_without_a_profile(model, prefetch):
    m, _ = model
    vol = _volume()
    plain_bins, plain_logits = _stream(m, vol, prefetch=prefetch)
    traced = []
    _profile(lambda: traced.extend(_stream(m, vol, prefetch=prefetch)))
    np.testing.assert_array_equal(traced[0], plain_bins)
    np.testing.assert_array_equal(traced[1], plain_logits)
    assert np.isfinite(plain_logits).all() and plain_bins.any()
