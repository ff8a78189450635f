"""The benchmark's data, arithmetic and plain reference, on the CPU.

    python3 -m pytest benchmark/tests -q
"""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.ndimage
import torch

from tiny import BENCH_DIR, REPO_ROOT, tiny_root

from benchlib import arith, cells, harness, phantom
from benchlib.trace import merge, program_kernel_names
from benchlib.weights import make_weights

SPEC = cells.benchmark_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "delivr_cfos_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = cells.find_cell(workload)
    assert cell.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                       if w["name"] == workload)
    assert cell.traffic["name"] == next(w["traffic"] for w in SPEC["workloads"]
                                        if w["name"] == workload)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "gvox_per_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        reader = cells.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
    assert hasattr(cells.reference_module(cell.config), "reference")


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + WORKLOADS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(WORKLOADS)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(REPO_ROOT, c["file"]))


def test_phantom_is_the_seeds():
    root_traffic = cells.find_cell(WORKLOADS[0]).traffic
    t = dict(root_traffic, volume_zyx=[64, 48, 40], brain_zyx=[64, 48, 40])
    a = phantom.make_phantom(t, 2**31 + 5, "cpu")
    b = phantom.make_phantom(t, 2**31 + 5, "cpu")
    c = phantom.make_phantom(t, 2**31 + 6, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    tissue = phantom.tissue_mask(t, "cpu")
    assert torch.equal(a > 0, tissue)  # exactly 0 outside the ellipsoid, never inside
    assert int(a.max()) <= phantom.MAX_U16 and int(a.max()) > 1000  # nuclei


def _active_from_geometry(traffic, roi, overlap):
    """Windows that touch the ellipsoid: the smallest sum of the per-axis
    terms over a window's voxels is the sum of each axis's smallest term."""
    shape, brain, off = traffic["volume_zyx"], traffic["brain_zyx"], traffic["offset_zyx"]
    ell = traffic["ellipsoid"]
    mins = []
    for ax in range(3):
        c = ell["center_frac"][ax] * brain[ax]
        a = ell["semi_axes_frac"][ax] * brain[ax] / 2
        t = ((np.arange(shape[ax]) + off[ax] + 0.5 - c) / a) ** 2
        mins.append([t[s:s + roi[ax]].min()
                     for s in phantom.window_starts(shape[ax], roi[ax], overlap)])
    total = np.add.outer(np.add.outer(mins[0], mins[1]), mins[2])
    return int((total <= 1.0).sum()), int(total.size)


@pytest.mark.parametrize("workload,active,warm", [
    ("delivr_unet.stream_brain", (1365, 1485), (396, 396)),
    ("delivr_unet_tta.stream_section", (198, 198), (198, 198)),
])
def test_active_windows(workload, active, warm):
    """The windows with tissue in the cell's volume and in its warm-up
    brain, the middle ``warm_rows`` window rows (harness.make_inputs): the
    warm-up holds more active windows than a batch of 128."""
    cell = cells.find_cell(workload)
    roi, overlap, tr = cell.config["window_zyx"], cell.config["overlap"], cell.traffic
    assert _active_from_geometry(tr, roi, overlap) == active
    planes = min(tr["volume_zyx"][0], (tr["warm_rows"] - 1) * int(roi[0] * overlap) + roi[0])
    z0 = (tr["volume_zyx"][0] - planes) // 2
    warm_tr = dict(tr, volume_zyx=[planes, *tr["volume_zyx"][1:]],
                   offset_zyx=[tr["offset_zyx"][0] + z0, *tr["offset_zyx"][1:]])
    assert _active_from_geometry(warm_tr, roi, overlap) == warm
    assert warm[0] > 128


def test_active_windows_counted_from_the_phantom(tmp_path):
    cell = cells.find_cell(WORKLOADS[0], tiny_root(tmp_path, WORKLOADS[0]))
    vol = phantom.make_phantom(cell.traffic, 11, "cpu")
    roi = cell.config["window_zyx"]
    assert phantom.active_windows(vol, roi, 0.5) == _active_from_geometry(cell.traffic, roi, 0.5)


@pytest.mark.parametrize("workload", ["delivr_unet.stream_brain", "delivr_unet_tta.stream_section"])
def test_forward_flops_and_conv_bound(workload):
    cfg = cells.find_cell(workload).config
    model = cells.model_module(cfg)
    flops = model.forward_flops(cfg)
    assert flops["conv3x3x3"] / 1e9 == pytest.approx(166.387, abs=1e-3)
    assert flops["deconv"] / 1e9 == pytest.approx(1.736, abs=1e-3)
    assert flops["final"] / 1e9 == pytest.approx(0.0377, abs=1e-4)
    assert flops["total"] / 1e9 == pytest.approx(168.16, abs=0.01)
    # at 128 windows: the 17 convs past the first, PERF.md's 21.40 ms
    # conv3d_cs bound, and with the C_in = 1 first conv (bytes-bound) too
    shapes = model.conv3d_cs_shapes(cfg)
    packed = sum(arith.conv_bound_s(128, d, h * w, ci, co) for _, ci, co, d, h, w in shapes[1:])
    assert 21.3e-3 <= packed <= 21.5e-3
    assert arith.convs_bound_s(shapes, 128) == pytest.approx(22.89e-3, abs=0.01e-3)


def _program_model(sd, precision="parity"):
    """The model that the program's stage 2 builds from the state dict
    (it infers the architecture from the keys and loads them strictly)."""
    import types

    from delivr_cfos_tpu_torch.pipeline.stage02_inference import (
        build_model, resolve_model_config)

    mc, _ = resolve_model_config(types.SimpleNamespace(precision=precision), sd, "cpu")
    return build_model(sd, mc, "cpu"), mc


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_weights_match_the_state_dict(config):
    """The weights that the configuration's model module makes, cut to its
    TINY sizes, are the state dict of the model that the program builds."""
    path = os.path.join(REPO_ROOT, next(c["file"] for c in SPEC["configs"] if c["name"] == config))
    cfg = cells.load_json(path)
    cfg.update(cells.model_module(cfg).TINY)
    sd = make_weights(cfg, 2**40 + 3, "cpu")
    model, _ = _program_model(sd)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    again = make_weights(cfg, 2**40 + 3, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_reference_erosion_is_scipys():
    from benchlib.cells import reference_module

    ref = reference_module(cells.find_cell(WORKLOADS[0]).config)
    rng = np.random.default_rng(3)
    mask = scipy.ndimage.binary_dilation(rng.random((20, 24, 18)) > 0.97, iterations=4)
    for n in (1, 3, 5):
        want = scipy.ndimage.binary_erosion(mask, iterations=n, border_value=1)
        got = ref.eroded_mask(torch.from_numpy(mask), n).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_programs_parity_forward(workload, tmp_path):
    """At TINY widths on the CPU, the reference's mean logits against the
    program's float32 streamed stage 2 (its TTA noise drawn alike)."""
    from delivr_cfos_tpu_torch.engine.sliding_window import SlidingWindowConfig
    from delivr_cfos_tpu_torch.engine.streaming import infer_volume_streaming

    root = tiny_root(tmp_path, workload)
    cell = cells.find_cell(workload, root)
    cfg = cell.config
    vol = phantom.make_phantom(cell.traffic, 21, "cpu")
    sd = make_weights(cfg, 22, "cpu")
    ref = cells.reference_module(cfg, root).reference(vol, sd, cfg)
    model, mc = _program_model(sd)
    logits = np.zeros(vol.shape, np.float32)
    infer_volume_streaming(
        model, vol.numpy().astype(np.uint16),
        SlidingWindowConfig(roi=tuple(cfg["window_zyx"]), tta=cfg["tta"],
                            erosion_iters=cfg["erosion_iters"]),
        mc, logits_out=logits)
    # float32 summation orders differ by about 1e-6; the reference draws TTA
    # noise of its own, which reads about 5e-6 here
    assert np.abs(logits - ref["mean"].numpy()).max() < (1e-5 if cfg["tta"] else 3e-6)


def test_union_of_intervals():
    s = np.array([0, 5, 2, 20, 30], np.int64)
    e = np.array([4, 8, 6, 25, 31], np.int64)
    m = merge(s, e, 1, 30)
    assert m.tolist() == [[1, 8], [20, 25]]


def test_program_kernel_names():
    names = program_kernel_names(os.path.join(REPO_ROOT, "delivr_cfos_tpu_torch"))
    assert {"conv3d_cs_packed_kernel", "conv3d_cs_pack_kernel", "deconv2x_cs_kernel",
            "conv3d_cs_direct_kernel"} <= set(names)


def _imports(path):
    tree = ast.parse(open(path).read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere_and_a_reference_apart_from_the_program():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in _sources("reference"):
        assert not set(_imports(path)) & (FORBIDDEN | {"delivr_cfos_tpu_torch", "benchlib"}), path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "delivr_cfos_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "delivr_cfos_tpu.fake", object())
    assert harness.forbidden_modules() == ["delivr_cfos_tpu"]


def test_jax_loaded_after_the_window_no_result(tmp_path, monkeypatch, capsys):
    """A module of JAX's that the reference (or a metric reader) loads once
    the window's own check has passed still keeps the result line out."""
    import types

    root = tiny_root(tmp_path, WORKLOADS[0])
    tiny = cells.find_cell(WORKLOADS[0], root)
    run_cell, reference_of = harness.run_cell, harness.reference_of

    def planting_reference(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return reference_of(*args, **kwargs)

    monkeypatch.setattr(harness, "reference_of", planting_reference)
    monkeypatch.setattr(harness, "run_cell", lambda cell, seed, seconds, trace, device, t0:
                        run_cell(tiny, seed, 0, trace, "cpu", t0, root=root))
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness.torch.cuda, "set_device", lambda d: None)
    rc = harness.main(["--workload", WORKLOADS[0], "--seed", "11", "--seconds", "0"])
    out = capsys.readouterr()
    assert rc != 0 and "jax" in out.err
    assert not any(line.startswith("{") for line in out.out.splitlines())


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", WORKLOADS[0], "--seed", str(2**33), "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_run_py_without_the_program_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    root = tiny_root(tmp_path, WORKLOADS[0])
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                        "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=root, capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and not p.stdout.strip().startswith("{")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace, tmp_path):
    root = tiny_root(tmp_path, WORKLOADS[0])
    cell = cells.find_cell(WORKLOADS[0], root)
    r = harness.run_cell(cell, 2**31 + 99, 0, bool(trace), "cpu", 0.0, root=root)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"outside_mask", "flip_margin", "flip_share"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    else:
        assert set(r["metrics"]) == {"gvox_per_s", "setup_s"}
    json.dumps(r, allow_nan=False)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                        "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                       cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
