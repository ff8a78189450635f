"""The SwinUNETR configuration's files, found by name as any architecture's:
its model module (``models/swin_unetr.py``), its plain reference
(``reference/swin_unetr_f32.py``), the attention kernel's arithmetic
(``benchlib/window_attention.py``) and its three per-layer readers, on the
CPU at the model module's TINY cut.

    python3 -m pytest benchmark/tests/test_bench_swin_unetr.py -q
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from tiny import tiny_root

from benchlib import arith, cells, harness
from benchlib.weights import make_weights
from benchlib.window_attention import attention_bound_s, window_heads

WORKLOAD = "swin_unetr.stream_brain"
# Limits of the tiny cell, from benchlib.harness's make_inputs, run_brain and
# reference_of on the CPU at these sizes, seeds 1-12: sound runs of the
# program read flip_margin up to 0.0688, the float8 control at least 0.3545.
# flip_share does not separate at these sizes (sound up to 0.0076, control
# down to 0.0060), so its tiny limit only sits above the sound runs
TINY_LIMITS = {"outside_mask": 0, "flip_margin": 0.15, "flip_share": 0.012}
SEED = 1  # flips voxels on both sides


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    return cells.find_cell(WORKLOAD).config


def test_model_and_reference_found_by_name():
    cfg = _config()
    assert (cfg["model"], cfg["reference"], cfg["control"]) == ("swin_unetr", "swin_unetr_f32",
                                                                 "fp8")
    mod = cells.model_module(cfg)
    for name in ("state_shapes", "forward_flops", "conv3d_cs_shapes", "TINY",
                 "window_attention_shapes"):
        assert hasattr(mod, name), name
    assert hasattr(cells.reference_module(cfg), "reference")
    assert cfg["reduced"] == ["plane_yx"]


def test_full_widths_arithmetic():
    """At feature size 48 on a (96, 96, 64) window: 62.19 M learnable
    parameters, 426.65 GFLOP a forward (379.91 in the 20 3×3×3 convs, 16.92
    in QKᵀ and PV), and the attention calls of one forward."""
    cfg = _config()
    mod = cells.model_module(cfg)
    assert sum(math.prod(s) for _, s, _, _ in mod.state_shapes(cfg)) == 62_186_659
    flops = mod.forward_flops(cfg)
    assert flops["conv3x3x3"] / 1e9 == pytest.approx(379.913, abs=1e-3)
    assert flops["attention"] / 1e9 == pytest.approx(16.915, abs=1e-3)
    assert flops["linear"] / 1e9 == pytest.approx(18.950, abs=1e-3)
    assert flops["total"] / 1e9 == pytest.approx(426.649, abs=1e-3)
    assert flops["total"] == pytest.approx(sum(v for k, v in flops.items() if k != "total"))
    assert len(mod.conv3d_cs_shapes(cfg)) == 20
    assert mod.conv3d_cs_shapes(cfg)[0] == ("encoder1.conv1", 1, 48, 96, 96, 64)
    assert mod.window_attention_shapes(cfg) == [
        (1, 245, 3, 343, False), (1, 245, 3, 343, True), (2, 48, 6, 343, False),
        (2, 48, 6, 343, True), (3, 8, 12, 343, False), (3, 8, 12, 343, True),
        (4, 1, 24, 144, False), (4, 1, 24, 144, False)]
    assert window_heads(mod.window_attention_shapes(cfg)) == 2286


def test_tiny_weights_are_the_programs_state_dict():
    from delivr_cfos_tpu_torch.models.registry import infer_model_config

    cfg = dict(_config())
    cfg.update(cells.model_module(cfg).TINY)
    sd = make_weights(cfg, 2**33 + 1, "cpu")
    model = infer_model_config(sd).build(sd, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    table = sd["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"]
    assert float(table.abs().max()) > 1.5  # drawn wide, not MONAI's std of 0.02


def test_reference_agrees_with_the_programs_parity_forward():
    """One TINY window: the reference's network against the program's f32
    forward on the same weights, to float32 summation order."""
    from delivr_cfos_tpu_torch.models.registry import infer_model_config

    cfg = dict(_config())
    cfg.update(cells.model_module(cfg).TINY)
    sd = make_weights(cfg, 5, "cpu")
    x = torch.rand((1, *cfg["window_zyx"], 1), generator=torch.Generator().manual_seed(6)) * 400
    ref = cells.reference_module(cfg).swin_unetr_forward(sd, x.permute(0, 4, 1, 2, 3), cfg)
    with torch.no_grad():
        got = infer_model_config(sd).build(sd, "cpu")(x).permute(0, 4, 1, 2, 3)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _tiny_cell(tmp_path):
    root = tiny_root(tmp_path, WORKLOAD)
    path = os.path.join(root, "benchmark", "configs", "swin_unetr.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["limits"] = TINY_LIMITS
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, cells.find_cell(WORKLOAD, root)


def test_sound_run_is_correct_and_the_control_is_not(tmp_path, monkeypatch):
    root, cell = _tiny_cell(tmp_path)
    r = harness.run_cell(cell, SEED, 0, False, "cpu", 0.0, root=root)
    assert r["correct"], r["checks"]
    assert r["checks"]["flip_share"]["value"] > 0  # the seed puts voxels near the cut
    program = harness.run_brain

    def control(cell, inputs, out_dir, device, brain="brain"):
        if brain != "brain":
            return program(cell, inputs, out_dir, device, brain)
        ref = harness.reference_of(cell, inputs, device, root, quant=cell.config["control"])
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "binaries.npy")
        np.save(path, ref["binary"].to(torch.uint8).numpy())
        return path

    monkeypatch.setattr(harness, "run_brain", control)
    r = harness.run_cell(cell, SEED, 0, False, "cpu", 0.0, root=root)
    assert not r["correct"], r["checks"]


def _trace(device, host):
    def arr(rows, i):
        return np.array([r[i] for r in rows], np.int64)
    return {"window": (0, 10_000),
            "device": {"name": [r[0] for r in device], "start": arr(device, 1),
                       "end": arr(device, 2)},
            "host": {"name": [r[0] for r in host], "start": arr(host, 1), "end": arr(host, 2)}}


def _record(trace, **kw):
    rec = {"trace": trace, "window_s": 10e-6, "busy_s": 5e-6, "config": _config(),
           "volumes": 2, "passes": 1, "forwards": 100}
    rec.update(kw)
    return rec


def test_readers():
    cfg = _config()
    shapes = cells.model_module(cfg).window_attention_shapes(cfg)
    device = [("window_attention_cs_kernel", 1000, 3000), ("conv3d_cs_packed_kernel", 3500, 6000),
              ("void (anonymous namespace)::window_attention_cs_kernel(...)", 2500, 4000)]
    host = [("model.swin_encoder", 500, 4500), ("model.forward_batch", 0, 9000),
            ("model.swin_encoder", 8000, 9000)]
    rec = _record(_trace(device, host))
    roof = cells.metric_reader("kernels.window_attention_roofline").read(rec)
    assert roof == pytest.approx(100.0 * attention_bound_s(shapes, 100, 2) / 3000e-9)
    # idle under the encoder spans: [500, 1000) and [8000, 9000) = 1500 ns
    idle = cells.metric_reader("model.swin_idle_share").read(rec)
    assert idle == pytest.approx(100.0 * 1500 / 10_000)
    assert cells.metric_reader("model.swin_idle_share").read(_record(_trace(device, []))) is None
    no_attention = _record(_trace(device[1:2], host))
    assert cells.metric_reader("kernels.window_attention_roofline").read(no_attention) is None


def test_attended_share_reads_the_counter(monkeypatch):
    from delivr_cfos_tpu_torch.utils import profiling

    cfg = _config()
    per = window_heads(cells.model_module(cfg).window_attention_shapes(cfg))
    reader = cells.metric_reader("model.attended_share")
    rec = _record(_trace([], []))
    monkeypatch.setattr(profiling, "read_counters",
                        lambda: {"model.window_heads_attended": 100 * per})
    assert reader.read(rec) == 100.0
    monkeypatch.setattr(profiling, "read_counters", lambda: {})
    assert reader.read(rec) is None


def test_roofline_bound_by_hand():
    """One stage-1 call at 10 windows: 4·n²·16 operations a window-head at
    the bf16 peak against q, k, v and output in bf16 and one f32 bias table
    at the HBM peak."""
    flops = 4.0 * 10 * 3 * 343**2 * 16
    nbytes = 2.0 * 10 * 343 * 48 * 4 + 4.0 * 3 * 343**2
    want = max(flops / arith.PEAK_BF16_FLOPS, nbytes / arith.PEAK_BYTES)
    assert attention_bound_s([(1, 10, 3, 343, False)], 1, 1) == pytest.approx(want)
