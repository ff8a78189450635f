"""The model modules and the phantom's nuclei, on the CPU: the yardstick
reads what it read before the model's arithmetic moved into
``benchmark/models/``, and a configuration of another architecture takes
new files alone.

    python3 -m pytest benchmark/tests/test_bench_models.py -q
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from tiny import BENCH_DIR, TINY_VOLUME, tiny_root

from benchlib import arith, cells, phantom
from benchlib.weights import make_weights

SPEC = cells.benchmark_spec()
EXISTING = ("delivr_unet.stream_brain", "delivr_unet_tta.stream_section")

# Recorded on the CPU from the harness as it was before the model modules
# (weights.state_shapes, arith.conv_shapes and arith.forward_flops, which
# took the configuration's widths directly), so that the existing cells read
# the same weights, phantoms, operations and bounds, to the bit.
GOLDEN_WEIGHTS = {
    7: "39007c87d058c90574f622968aa530137b8dd9a7bfd0648da18d3245d8a44e75",
    2**31 + 5: "100c2cc05f4f0ea820d8de2f317bc4fe282f8dc5daa7dcdcb8535d7c15161223",
}
GOLDEN_FLOPS = {"conv3x3x3": 166386991104.0, "deconv": 1736441856.0, "final": 37748736.0,
                "total": 168161181696.0}
GOLDEN_BOUNDS = {(128, 1): 0.02289085518035513, (1365 * 7, 7): 1.7087665373578138}
GOLDEN_PHANTOMS = {
    ("delivr_unet.stream_brain", "tiny", 11):
        "d34d38d577cc13badf3857f569e3d8adac832ec37c91faf9bf0b47f11f76743f",
    ("delivr_unet.stream_brain", "tiny", 2**31 + 5):
        "72e58335ab5041735f879eb8041dc8de7fb8851b009e731a9662f12217cd99a7",
    ("delivr_unet_tta.stream_section", "tiny", 11):
        "d34d38d577cc13badf3857f569e3d8adac832ec37c91faf9bf0b47f11f76743f",
    ("delivr_unet_tta.stream_section", "tiny", 2**31 + 5):
        "72e58335ab5041735f879eb8041dc8de7fb8851b009e731a9662f12217cd99a7",
    ("delivr_unet.stream_brain", "eighth", 11):
        "7129d8b52a94975a20eb5915932366a4052c2493b141e14efd4805c7e962e373",
    ("delivr_unet.stream_brain", "eighth", 2**31 + 5):
        "7fbcba175b44925008f418695ac0ffd7c083271babd20b0670fe1d9143942c38",
    ("delivr_unet_tta.stream_section", "eighth", 11):
        "f909285c3d4249ae0e6c4f2f086543dfb462fd56619ebdc6dbf1eec379fb736a",
    ("delivr_unet_tta.stream_section", "eighth", 2**31 + 5):
        "5c76a920cfd3a5589db822ee3eb5fe008e3d394779b4f5d027475cc55f3e38a8",
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(tensors: dict) -> str:
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(GOLDEN_WEIGHTS))
@pytest.mark.parametrize("workload", EXISTING)
def test_weights_are_as_before(workload, seed):
    cfg = cells.find_cell(workload).config
    assert _sha(make_weights(cfg, seed, "cpu")) == GOLDEN_WEIGHTS[seed]


@pytest.mark.parametrize("workload", EXISTING)
def test_flops_and_bounds_are_as_before(workload):
    cfg = cells.find_cell(workload).config
    model = cells.model_module(cfg)
    assert model.forward_flops(cfg) == GOLDEN_FLOPS
    for (windows, reads), want in GOLDEN_BOUNDS.items():
        assert arith.convs_bound_s(model.conv3d_cs_shapes(cfg), windows,
                                   weight_reads=reads) == want


@pytest.mark.parametrize("workload,cut,seed", sorted(GOLDEN_PHANTOMS))
def test_phantoms_are_as_before(workload, cut, seed, tmp_path):
    """At the tiny cut (tiny.py) and at an eighth of each extent, which
    keeps each traffic's own geometry."""
    if cut == "tiny":
        traffic = cells.find_cell(workload, tiny_root(tmp_path, workload)).traffic
    else:
        traffic = dict(cells.find_cell(workload).traffic)
        traffic.update({k: [v // 8 for v in traffic[k]]
                        for k in ("volume_zyx", "brain_zyx", "offset_zyx")})
    vol = phantom.make_phantom(traffic, seed, "cpu")
    assert _sha({"": vol}) == GOLDEN_PHANTOMS[(workload, cut, seed)]


def _single_draw(tissue, n, g):
    """The phantom's centres as one draw of 8·n candidates placed them."""
    cand = torch.rand((8 * n, 3), generator=g, dtype=torch.float64)
    cand = cand * torch.tensor(tissue.shape, dtype=torch.float64)
    idx = cand.floor().long()
    return cand[tissue[idx[:, 0], idx[:, 1], idx[:, 2]]][:n]


@pytest.mark.parametrize("semi_axes,share", [(0.3, (0.01, 0.02)), (0.45, (0.04, 0.05)),
                                             (0.95, (0.44, 0.46))])
def test_nuclei_at_any_tissue_share(semi_axes, share):
    """Under an eighth of the volume in tissue, one draw of 8·n leaves
    fewer than n centres and further draws find the rest; above it, the
    centres are those of the one draw, as before."""
    traffic = dict(cells.find_cell(EXISTING[0]).traffic, volume_zyx=[64, 48, 40],
                   brain_zyx=[64, 48, 40], offset_zyx=[0, 0, 0])
    traffic["ellipsoid"] = {"center_frac": [0.5, 0.5, 0.5], "semi_axes_frac": [semi_axes] * 3}
    tissue = phantom.tissue_mask(traffic, "cpu")
    assert share[0] < float(tissue.float().mean()) < share[1]
    n = 60
    got = phantom.nucleus_centres(tissue, n, phantom.generator(9, "cpu"))
    idx = got.floor().long()
    assert got.shape == (n, 3) and bool(tissue[idx[:, 0], idx[:, 1], idx[:, 2]].all())
    one = _single_draw(tissue, n, phantom.generator(9, "cpu"))
    if share[0] > 1 / 8:
        assert torch.equal(got, one)
    else:
        assert one.shape[0] < n and torch.equal(got[:one.shape[0]], one)
    assert _nuclei_added(traffic, 5000, 5) > 500  # raised under an eighth before


def _nuclei_added(traffic, per_mvox, seed):
    """The largest value that the nuclei add to the phantom: the same seed
    without nuclei gives the same texture."""
    with_nuclei = dict(traffic, nuclei=dict(traffic["nuclei"], per_mvox_tissue=per_mvox))
    without = dict(traffic, nuclei=dict(traffic["nuclei"], per_mvox_tissue=0))
    diff = (phantom.make_phantom(with_nuclei, seed, "cpu")
            - phantom.make_phantom(without, seed, "cpu"))
    return int(diff.max())


def test_no_tissue_raises():
    with pytest.raises(RuntimeError, match="no tissue"):
        phantom.nucleus_centres(torch.zeros(4, 4, 4, dtype=torch.bool), 3,
                                phantom.generator(1, "cpu"))


def test_no_model_names_outside_its_module():
    """No file of the benchmark names the BasicUNet's state-dict blocks or
    its width key outside its model module, the configurations and its
    plain reference."""
    cfg = cells.find_cell(EXISTING[0]).config
    mod = cells.model_module(cfg)
    blocks = {k.split(".")[0] for k, *_ in mod.state_shapes(cfg)}
    blocks |= {re.sub(r"\d+$", "", b) for b in blocks}
    widths = set(mod.TINY) - {"window_zyx"}  # the window is the sliding window's
    words = re.compile(r"\b(" + "|".join(sorted(map(re.escape, blocks | widths))) + r")(\b|\d)")
    allowed = {os.path.join("models", "basic_unet.py"), os.path.join("reference", "stage2_f32.py")}
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), BENCH_DIR)
            if rel in allowed or rel.startswith("configs" + os.sep) or "__pycache__" in rel:
                continue
            text = open(os.path.join(d, f), encoding="utf-8").read()
            assert not words.search(text), (rel, words.search(text).group(0))


# A configuration of another architecture, as a later change would add it:
# a model module, its reference and its configuration, and new entries in
# BENCHMARK.json; nothing that is there is edited.
TOY_MODEL = '''
"""A toy model: one 3x3x3 conv of C channels and a 1x1x1 head."""

TINY = {"channels": 2, "window_zyx": [16, 16, 16]}


def state_shapes(config):
    c = config["channels"]
    return [("body.weight", (c, 1, 3, 3, 3), 0.5, 0.0), ("body.bias", (c,), 0.5, 0.0),
            ("head.weight", (1, c, 1, 1, 1), 0.25, 1.0)]


def conv3d_cs_shapes(config):
    z, y, x = config["window_zyx"]
    return [("body", 1, config["channels"], z, y, x)]


def forward_flops(config):
    z, y, x = config["window_zyx"]
    body = 2.0 * 27 * config["channels"] * z * y * x
    head = 2.0 * config["channels"] * z * y * x
    return {"body": body, "head": head, "total": body + head}
'''
TOY_REFERENCE = '''
"""The toy model's plain reference."""


def reference(volume, sd, config, quant=None, batch=8):
    raise NotImplementedError
'''
TOY_CONFIG = {"name": "toy", "model": "toy_net", "reference": "toy_plain", "channels": 24,
              "in_channels": 1, "out_channels": 1, "plane_yx": [480, 384],
              "window_zyx": [96, 96, 64]}
TOY_PROBE = '''
import json, os, sys
root = os.getcwd()
sys.path[:0] = [os.path.join(root, "benchmark"), root]
import numpy as np
from benchlib import cells
from benchlib.weights import make_weights
cell = cells.find_cell("toy.stream_brain")
sd = make_weights(cell.config, 3, "cpu")
trace = {"window": (0, 2 * 10**9),
         "device": {"name": ["conv3d_cs_packed_kernel"], "start": np.array([0], np.int64),
                    "end": np.array([10**9], np.int64)},
         "host": {"name": [], "start": np.array([], np.int64), "end": np.array([], np.int64)}}
record = {"trace": trace, "window_s": 2.0, "busy_s": 1.0, "forwards": 1000, "volumes": 2,
          "passes": 1, "config": cell.config}
print(json.dumps({
    "benchlib": cells.__file__, "model": cell.config["model"],
    "weights": {k: list(v.shape) for k, v in sd.items()},
    "reference": hasattr(cells.reference_module(cell.config), "reference"),
    "mfu": cells.metric_reader("model.mfu").read(record),
    "roofline": cells.metric_reader("kernels.conv3d_cs_roofline").read(record),
}))
'''


def test_another_architecture_from_new_files_alone(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (root / "benchmark" / "models" / "toy_net.py").write_text(TOY_MODEL)
    (root / "benchmark" / "reference" / "toy_plain.py").write_text(TOY_REFERENCE)
    (root / "benchmark" / "configs" / "toy.json").write_text(json.dumps(TOY_CONFIG))
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy.json", "reduced": [],
                            "why": "a toy architecture"})
    spec["workloads"].append({"name": "toy.stream_brain", "config": "toy",
                              "traffic": "stream_brain", "chips": 1, "why": "a toy cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    # every file that was there is there unchanged; BENCHMARK.json only gained entries
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), BENCH_DIR)
            if "__pycache__" not in rel:
                assert (root / "benchmark" / rel).read_bytes() == open(
                    os.path.join(d, f), "rb").read(), rel
    with open(root / "BENCHMARK.json") as f:
        grown = json.load(f)
    assert {k: v[:len(SPEC[k])] if isinstance(v, list) else v for k, v in grown.items()} == SPEC

    p = subprocess.run([sys.executable, "-c", TOY_PROBE], cwd=root, capture_output=True,
                       text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["benchlib"].startswith(str(root))
    toy = cells.model_module(TOY_CONFIG, str(root))
    assert got["model"] == "toy_net" and got["reference"]
    assert got["weights"] == {k: list(s) for k, s, _, _ in toy.state_shapes(TOY_CONFIG)}
    flops = 1000 * toy.forward_flops(TOY_CONFIG)["total"]
    assert got["mfu"] == pytest.approx(100.0 * flops / 2.0 / arith.PEAK_BF16_FLOPS, rel=1e-12)
    least = sum(arith.conv_bound_s(1000, d, h * w, ci, co, True, 2)
                for _, ci, co, d, h, w in toy.conv3d_cs_shapes(TOY_CONFIG))
    assert got["roofline"] == pytest.approx(100.0 * least / 1.0, rel=1e-12)
    basic = cells.find_cell(EXISTING[0]).config
    basic_least = arith.convs_bound_s(cells.model_module(basic).conv3d_cs_shapes(basic), 1000, 2)
    assert got["roofline"] != pytest.approx(100.0 * basic_least)


def test_tiny_cut_comes_from_the_model_module(tmp_path):
    for w in SPEC["workloads"]:
        cfg = cells.find_cell(w["name"], tiny_root(tmp_path / w["name"], w["name"])).config
        tiny = cells.model_module(cfg).TINY
        assert {k: cfg[k] for k in tiny} == tiny
        assert list(cfg["plane_yx"]) == TINY_VOLUME[1:]


def test_a_configuration_names_its_model(tmp_path):
    root = tiny_root(tmp_path, EXISTING[0])
    path = os.path.join(root, next(c["file"] for c in SPEC["configs"]
                                   if c["name"] == "delivr_unet"))
    cfg = cells.load_json(path)
    del cfg["model"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="names no model"):
        cells.find_cell(EXISTING[0], root)
