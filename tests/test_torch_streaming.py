"""The port's out-of-core streaming engine and its stage-2 branch, against
the JAX package's streaming engine and the port's in-memory engine, on the
same weights and volumes (parity mode on the CPU).

Mirrors tests/test_streaming.py, tests/test_streaming_resume.py and
tests/test_stage02_out_of_core.py. Logits agree within 1e-4 (f32 sums in
another order: the slab carry is added before the slab's windows).
Binaries are compared exactly where the sums cannot reach the sigmoid cut
(a fully foreground volume, or against the in-memory engine of the same
package outside the 1e-3 logit band); resume and prefetch give the same
bits as an uninterrupted run. Host memory is bounded by the growth of
RssAnon, which sees torch's allocations (tracemalloc does not)."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

import torch

from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.engine import sliding_window as jsw
from delivr_cfos_tpu.engine.streaming import (
    infer_volume_streaming as jax_streaming,
    resume_signature as jax_signature,
)
from delivr_cfos_tpu.models.basic_unet import BasicUNetConfig as JaxConfig
from delivr_cfos_tpu.models.convert import save_params_npz, torch_state_dict_to_params
from delivr_cfos_tpu.pipeline.stage02_inference import run_inference as jax_run
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.engine import streaming as st
from delivr_cfos_tpu_torch.engine.sliding_window import SlidingWindowConfig, infer_volume
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.ops.morphology import binarize_logits
from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
ROI = (16, 16, 16)
PORT_CFG = BasicUNetConfig(features=TINY)
JAX_CFG = JaxConfig(features=TINY)
BAND = 1e-3  # |logit| inside which sums in another order may flip a voxel


@pytest.fixture(scope="module")
def weights():
    sd = init_state_dict(PORT_CFG, torch.Generator().manual_seed(5))
    return build_model(sd, PORT_CFG, "cpu"), torch_state_dict_to_params(sd)


def _half_bright(shape, seed, offset=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint16)
    vol[:, : shape[1] // 2] = (
        rng.random((shape[0], shape[1] // 2, shape[2])) * 800 + offset
    ).astype(np.uint16)
    return vol


def _cfg(**kw):
    return SlidingWindowConfig(**{"roi": ROI, "batch_size": 4, **kw})


def _stream(model, vol, cfg, out_shape=None, **kw):
    """Port streaming run; returns (binaries, logits)."""
    logits = np.full(out_shape or vol.shape, np.nan, np.float32)
    bins, _ = st.infer_volume_streaming(model, vol, cfg, PORT_CFG,
                                        logits_out=logits, out_shape=out_shape, **kw)
    return bins, logits


def _assert_binaries_outside_band(got, want, logits):
    outside = np.abs(logits) > BAND
    assert outside.mean() > 0.99
    np.testing.assert_array_equal(got[outside], want[outside])


# ---------------- the engine against JAX's and the in-memory engine ----------


@pytest.mark.parametrize("slab_z_starts", [1, 2, 3])
def test_streaming_matches_jax_streaming(weights, slab_z_starts):
    model, params = weights
    vol = _half_bright((72, 32, 32), 0)
    cfg = _cfg(erosion_iters=3)
    j_log = np.empty(vol.shape, np.float32)
    j_bin, _ = jax_streaming(
        params, vol, jsw.SlidingWindowConfig(**dataclasses.asdict(cfg)), JAX_CFG,
        slab_z_starts=slab_z_starts, logits_out=j_log,
    )
    bins, logits = _stream(model, vol, cfg, slab_z_starts=slab_z_starts)
    np.testing.assert_allclose(logits, j_log, rtol=1e-4, atol=1e-4)
    assert int(j_bin.sum()) > 0
    _assert_binaries_outside_band(bins, j_bin, j_log)


def test_streaming_logits_match_in_memory(weights):
    model, _ = weights
    vol = _half_bright((72, 32, 32), 1)
    cfg = _cfg()
    want, want_bin = infer_volume(model, vol, cfg, PORT_CFG)
    bins, logits = _stream(model, vol, cfg, slab_z_starts=2)
    np.testing.assert_allclose(logits, want.numpy(), rtol=1e-4, atol=1e-4)
    _assert_binaries_outside_band(bins, want_bin.numpy(), want.numpy())


def test_streaming_binaries_match_on_fully_foreground_volume(weights):
    """All-positive input: the eroded mask is all ones, and binaries equal
    the in-memory engine's exactly."""
    model, _ = weights
    vol = (np.random.default_rng(2).random((48, 32, 32)) * 800 + 1).astype(np.uint16)
    cfg = _cfg()
    _, want_bin = infer_volume(model, vol, cfg, PORT_CFG)
    bins, _ = st.infer_volume_streaming(model, vol, cfg, PORT_CFG, slab_z_starts=2)
    np.testing.assert_array_equal(bins, want_bin.numpy())


def test_streaming_crop_and_erosion_match_in_memory(weights, tmp_path):
    """A padded memmap volume whose real extent is smaller, with a masked-out
    band straddling a chunk cut: crop-then-binarize, as stage 2 does."""
    model, _ = weights
    rng = np.random.default_rng(7)
    path = str(tmp_path / "vol.npy")
    vol = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint16, shape=(80, 32, 32))
    rz, ry, rx = 70, 28, 30
    vol[:rz, :ry, :rx] = (rng.random((rz, ry, rx)) * 700 + 10).astype(np.uint16)
    vol[30:34, 5:20, 5:20] = 0  # z = 32 is a chunk cut at slab_z_starts 2
    vol.flush()
    ro = np.load(path, mmap_mode="r")
    cfg = _cfg(erosion_iters=3)
    mean, _ = infer_volume(model, np.asarray(ro), cfg, PORT_CFG, return_binary=False)
    real = mean[:rz, :ry, :rx]
    want_bin = binarize_logits(real, torch.from_numpy(np.asarray(ro[:rz, :ry, :rx]) > 0),
                               cfg.threshold, cfg.erosion_iters).numpy()
    sig = np.zeros((rz, ry, rx), np.float32)
    bins, logits = _stream(model, ro, cfg, out_shape=(rz, ry, rx), slab_z_starts=2,
                           sigmoid_out=sig)
    np.testing.assert_allclose(logits, real.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sig, torch.sigmoid(real).numpy(), atol=1e-5)
    _assert_binaries_outside_band(bins, want_bin, real.numpy())


def test_device_erosion_context_matches_in_memory(weights):
    """E ≤ roi_z − stride_z: each chunk's erosion context comes from device
    slab planes and the carried planes below the slab; a zero band makes the
    re-mask bite at the chunk cuts."""
    model, _ = weights
    vol = _half_bright((72, 32, 32), 11, offset=10)
    vol[30:40] = 0
    cfg = _cfg(erosion_iters=4)
    mean, bins = infer_volume(model, vol, cfg, PORT_CFG)
    for prefetch in (True, False):
        got, _ = _stream(model, vol, cfg, slab_z_starts=2, prefetch=prefetch)
        _assert_binaries_outside_band(got, bins.numpy(), mean.numpy())


def test_prefetch_bit_identical(weights):
    """The loader and writer threads only move where the same work runs."""
    model, _ = weights
    vol = _half_bright((72, 32, 32), 9)
    cfg = _cfg(tta=True, tta_noise_std=0.2)
    a_bin, a_log = _stream(model, vol, cfg, slab_z_starts=2, prefetch=True)
    b_bin, b_log = _stream(model, vol, cfg, slab_z_starts=2, prefetch=False)
    np.testing.assert_array_equal(a_log, b_log)
    np.testing.assert_array_equal(a_bin, b_bin)


# ---------------- resume ----------------


def _write_sidecar(path, sig, next_slab, finalized):
    with open(path, "w") as f:
        json.dump({"sig": sig, "next_slab": next_slab, "finalized": finalized}, f)


@pytest.mark.parametrize("tta", [False, True])
def test_resume_bit_identical(weights, tmp_path, tta):
    """Hand-write the sidecar an interruption after slab 1 leaves (slab
    starts 0, 8 | 16, 24 | 32, ...), corrupt everything not yet final, and
    resume: the same bits as an uninterrupted run, TTA noise included (each
    slab seeds its own generator)."""
    model, _ = weights
    vol = _half_bright((72, 32, 32), 3)
    cfg = _cfg(tta=tta, tta_noise_std=0.3)
    full_bin, full_log = _stream(model, vol, cfg, slab_z_starts=2)
    state = str(tmp_path / "resume.json")
    _write_sidecar(state, st.resume_signature(cfg, vol.shape, vol.shape, 2, batch=4), 2, 32)
    res_log, res_bin = full_log.copy(), full_bin.copy()
    res_log[32:], res_bin[32:] = -1, 255
    st.infer_volume_streaming(model, vol, cfg, PORT_CFG, slab_z_starts=2,
                              binary_out=res_bin, logits_out=res_log,
                              resume_state_path=state)
    assert not os.path.exists(state)
    np.testing.assert_array_equal(res_log, full_log)
    np.testing.assert_array_equal(res_bin, full_bin)


@pytest.mark.parametrize("sidecar", ["bogus", "jax_package", "importance"])
def test_mismatched_sidecar_restarts_from_scratch(weights, tmp_path, sidecar):
    """A sidecar of another config, of the JAX package's engine (its noise
    and sums differ), or of another importance mode is never a resume
    point: every plane is recomputed."""
    model, _ = weights
    vol = _half_bright((48, 32, 32), 1)
    cfg = _cfg(importance="gaussian")
    want_bin, want_log = _stream(model, vol, cfg, slab_z_starts=2)
    sig = {
        "bogus": {"bogus": True},
        "jax_package": jax_signature(jsw.SlidingWindowConfig(**dataclasses.asdict(cfg)),
                                     vol.shape, vol.shape, 2, batch=4),
        "importance": st.resume_signature(_cfg(), vol.shape, vol.shape, 2, batch=4),
    }[sidecar]
    state = str(tmp_path / "resume.json")
    _write_sidecar(state, sig, 2, 32)
    res_log = np.full(vol.shape, -123.0, np.float32)
    res_bin = np.full(vol.shape, 255, np.uint8)
    st.infer_volume_streaming(model, vol, cfg, PORT_CFG, slab_z_starts=2,
                              binary_out=res_bin, logits_out=res_log,
                              resume_state_path=state)
    np.testing.assert_array_equal(res_log, want_log)
    np.testing.assert_array_equal(res_bin, want_bin)


def test_resume_rebuilds_erosion_carry_from_host(weights, tmp_path):
    """z = 42, roi_z 16, stride 8: starts [0, 8, 16, 24, 26]. Resuming at
    next_slab 4 (slab_z_starts 1) regenerates slab 3 (z0 = 24, next 26),
    and E = 8 needs planes from z = 18, below it: they come from the host
    volume, the same bytes the carry chain would hold."""
    model, _ = weights
    vol = _half_bright((42, 32, 32), 13, offset=10)
    vol[20:23] = 0
    cfg = _cfg(erosion_iters=8)
    full_bin, full_log = _stream(model, vol, cfg, slab_z_starts=1)
    state = str(tmp_path / "resume.json")
    _write_sidecar(state, st.resume_signature(cfg, vol.shape, vol.shape, 1, batch=4), 4, 26)
    res_log, res_bin = full_log.copy(), full_bin.copy()
    res_log[26:], res_bin[26:] = -1, 255
    st.infer_volume_streaming(model, vol, cfg, PORT_CFG, slab_z_starts=1,
                              binary_out=res_bin, logits_out=res_log,
                              resume_state_path=state)
    np.testing.assert_array_equal(res_log, full_log)
    np.testing.assert_array_equal(res_bin, full_bin)


def test_signature_covers_batch_slab_and_engine():
    cfg = _cfg()
    shape = (72, 32, 32)
    sig = st.resume_signature(cfg, shape, shape, 2, batch=4)
    assert sig == json.loads(json.dumps(sig)) and sig["engine"] == st.ENGINE
    assert sig != st.resume_signature(cfg, shape, shape, 2, batch=8)
    assert sig != st.resume_signature(cfg, shape, shape, 3, batch=4)
    assert sig != st.resume_signature(_cfg(seed=1), shape, shape, 2, batch=4)
    assert st._slab_seed(0, 1) != st._slab_seed(0, 2) != st._slab_seed(1, 2)


# ---------------- stage 2 ----------------


def _stage2_brain(tmp, vol, **bd):
    d = tmp / "in" / "brain" / "masked_niftis"
    os.makedirs(d, exist_ok=True)
    mm = np.lib.format.open_memmap(str(d / "masked_nifti.npy"), mode="w+",
                                   dtype=np.uint16, shape=(1, 1, *vol.shape))
    mm[0, 0] = vol
    mm.flush()
    del mm

    def raw(out, load_all_ram, roi=ROI, **extra):
        return {
            "output_location": str(tmp),
            "blob_detection": {
                "input_location": "in/",
                "model_location": str(tmp / "w.npz"),
                "output_location": out,
                "window_dimensions": {f"window_dim_{i}": roi[i] for i in range(3)},
                **bd, **extra,
            },
            "FLAGS": {"TEST_TIME_AUGMENTATION": False, "SAVE_ACTIVATED_OUTPUT": True,
                      "LOAD_ALL_RAM": load_all_ram},
        }

    return raw


def _outputs(session):
    d = os.path.join(session, "binary_segmentations")
    return (np.load(os.path.join(d, "binaries.npy")),
            np.load(os.path.join(d, "network_output.npy")),
            os.path.exists(os.path.join(d, "streaming_resume.json")))


def _logit(sig):
    return np.log(np.clip(sig, 1e-12, None)) - np.log(np.clip(1 - sig, 1e-12, None))


@pytest.fixture(scope="module")
def brain(tmp_path_factory):
    """A padded (80, 32, 40) masked volume, real (70, 28, 38), with a
    masked-out band across a chunk cut, and .npz weights for both packages."""
    tmp = tmp_path_factory.mktemp("stream_stage02")
    rng = np.random.default_rng(17)
    vol = np.zeros((80, 32, 40), np.uint16)
    vol[:70, :28, :38] = (rng.random((70, 28, 38)) * 600 + 5).astype(np.uint16)
    vol[30:34, 4:20, 6:22] = 0
    sd = init_state_dict(PORT_CFG, torch.Generator().manual_seed(8))
    save_params_npz(str(tmp / "w.npz"), torch_state_dict_to_params(sd))
    return _stage2_brain(tmp, vol, erosion_iters=2), (1, 1, 70, 28, 38)


def test_stage02_streaming_matches_jax_and_in_memory(brain):
    raw, stack = brain
    j_bin, j_sig, _ = _outputs(jax_run(JaxPipelineConfig.from_dict(raw("jax/", False)),
                                       "brain", stack))
    s_bin, s_sig, s_side = _outputs(run_inference(
        PipelineConfig.from_dict(raw("stream/", False)), "brain", stack, device="cpu"))
    m_bin, m_sig, _ = _outputs(run_inference(
        PipelineConfig.from_dict(raw("memory/", True)), "brain", stack, device="cpu"))
    assert s_bin.shape == j_bin.shape == stack[2:] and s_bin.dtype == np.uint8
    assert not s_side
    assert int(j_bin.sum()) > 0
    np.testing.assert_allclose(s_sig, j_sig, atol=1e-4)
    np.testing.assert_allclose(s_sig, m_sig, atol=1e-5)
    _assert_binaries_outside_band(s_bin, j_bin, _logit(j_sig))
    _assert_binaries_outside_band(s_bin, m_bin, _logit(m_sig))


def test_stage02_resumes_an_interrupted_stream(brain, monkeypatch):
    """An error in slab 2 leaves the sidecar that slab 1's chunk wrote; the
    re-run reopens binaries.npy in place, recomputes from the sidecar and
    gives the bits of an uninterrupted run."""
    raw, stack = brain
    cfg = PipelineConfig.from_dict(raw("resume/", False))
    want_bin, want_sig, _ = _outputs(run_inference(
        PipelineConfig.from_dict(raw("whole/", False)), "brain", stack, device="cpu"))

    real_accumulate = st._accumulate
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("interrupted")
        return real_accumulate(*args, **kw)

    monkeypatch.setattr(st, "_accumulate", failing)
    with pytest.raises(RuntimeError, match="interrupted"):
        run_inference(cfg, "brain", stack, device="cpu")
    monkeypatch.setattr(st, "_accumulate", real_accumulate)
    session = os.path.join(cfg.blob_detection.output_location, "brain")
    d = os.path.join(session, "binary_segmentations")
    with open(os.path.join(d, "streaming_resume.json")) as f:
        state = json.load(f)
    assert state["next_slab"] == 2 and state["finalized"] == 64
    bins = np.load(os.path.join(d, "binaries.npy"), mmap_mode="r+")
    bins[64:] = 255
    bins.flush()
    del bins

    got_bin, got_sig, side = _outputs(run_inference(cfg, "brain", stack, device="cpu"))
    assert not side
    np.testing.assert_array_equal(got_bin, want_bin)
    np.testing.assert_array_equal(got_sig, want_sig)


def _rss_anon_kib():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:"):
                return int(line.split()[1])
    raise RuntimeError("no RssAnon in /proc/self/status")


def test_stage02_streaming_bounds_host_memory(tmp_path):
    """A (1024, 160, 160) brain, bright in one corner, streams through stage
    2: the peak growth of anonymous host memory (sampled every 2 ms) stays
    under one full-volume f32 buffer (105 MB), which the in-memory engine
    would need twice over for its accumulators alone. A small run first
    takes the process's one-time allocations (thread pools, first-forward
    workspaces) out of the measurement."""
    shape = (1024, 160, 160)
    vol = np.zeros(shape, np.uint16)
    vol[400:440, 20:60, 30:70] = (
        np.random.default_rng(4).random((40, 40, 40)) * 600 + 5).astype(np.uint16)
    raw = _stage2_brain(tmp_path / "big", vol, erosion_iters=2)
    sd = init_state_dict(PORT_CFG, torch.Generator().manual_seed(9))
    cfg = PipelineConfig.from_dict(raw("out/", False))
    warm = _stage2_brain(tmp_path / "warm", vol[380:460], erosion_iters=2)
    run_inference(PipelineConfig.from_dict(warm("out/", False)), "brain",
                  (1, 1, 80, *shape[1:]), params=sd, device="cpu")
    del vol

    base = _rss_anon_kib()
    peak = [base]
    done = threading.Event()

    def watch():
        while not done.is_set():
            peak[0] = max(peak[0], _rss_anon_kib())
            time.sleep(0.002)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        session = run_inference(cfg, "brain", (1, 1, *shape), params=sd, device="cpu")
    finally:
        done.set()
        watcher.join(timeout=10)
    assert not watcher.is_alive()
    bins, sig, side = _outputs(session)
    assert not side and bins.shape == shape and np.isfinite(sig).all()
    assert int(bins.sum()) > 0
    growth = (peak[0] - base) * 1024
    full_f32 = int(np.prod(shape)) * 4
    assert growth < full_f32, f"RssAnon grew {growth} B ≥ full-volume f32 {full_f32} B"
