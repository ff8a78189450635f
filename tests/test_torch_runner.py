"""The port's runner and CLI (``pipeline/runner.py::run_pipeline``,
``python -m delivr_cfos_tpu_torch``) against the JAX package's on the CPU.

Mirrors tests/test_pipeline_e2e.py (stages 1-3 with tiny random weights),
tests/test_pipeline_stages456.py (stages 3-6 on pre-seeded binaries, stage 4
in its fallback mode, a synthetic ontology and a half-size annotation grid
that the seeded blobs land in), tests/test_cli.py and tests/test_hooks.py.
The same config run through both packages prints the same HOOK lines and
writes equal files: stage 1's and stages 3-6's byte for byte (zip
containers, .xlsx and .npz, member by member: the zip stamps each member
with the clock's time), stage 2's binaries wherever the JAX package's mean
logit lies outside the ±1e-3 band at the sigmoid cut (both in parity on the
CPU; sigmoids within 1e-4). Also: reruns skip, the SAVE_* cleanup,
``dcn_slices > 1`` on one device runs undistributed, ``$DELIVR_TRACE_DIR``
writes a trace, and the
repair of a failed stage 2 that the JAX runner would take as finished. The
JAX side runs its host labelers (``tests/jax_host_labelers.py``).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from delivr_cfos_tpu.__main__ import main as jax_main
from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.models.convert import save_params_npz, torch_state_dict_to_params
from delivr_cfos_tpu.pipeline.runner import run_pipeline as jax_run_pipeline
from delivr_cfos_tpu.utils.hooks import HookEmitter as JaxHookEmitter
from delivr_cfos_tpu_torch.__main__ import main
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.models import basic_unet
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig, init_state_dict
from delivr_cfos_tpu_torch.pipeline.runner import run_pipeline
from delivr_cfos_tpu_torch.pipeline.stage02_inference import IN_PROGRESS, inference_done
from delivr_cfos_tpu_torch.utils.hooks import HookEmitter
from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff, write_tiff_stack
from jax_host_labelers import jax_host_labelers  # noqa: F401 (autouse)
from test_pipeline_e2e import _make_raw_brain as _make_blob_brain
from test_pipeline_stages456 import ONTOLOGY_XML, _make_binaries
from test_pipeline_stages456 import _make_raw_brain as _make_bright_brain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (4, 4, 8, 16, 32, 4)
RAW_SHAPE = (8, 64, 48)  # both mirrored tests' raw brain
BAND = 1e-3  # |logit| inside which parity runs may disagree at the cut
HALF_GRID = (228, 264, 160)  # half the CCF3 grid in each axis
# raw-space blob centres whose fallback-warped cells land in HALF_GRID; the
# last (in raster order) is dropped by stage 3's range(1, N)
BLOBS = [(2, 40, 30), (2, 56, 40), (3, 48, 34), (6, 20, 20)]


def _capture(fn, *args, **kw):
    """fn's stdout (the HOOK lines and the log)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def _hooks(text):
    return [line for line in text.splitlines() if line.startswith("HOOK:")]


def _tree(root):
    """{relative path: bytes} under ``root``; a zip container as its
    [(member, bytes)] in order."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith((".xlsx", ".npz")):
                with zipfile.ZipFile(path) as z:
                    out[rel] = [(i.filename, z.read(i)) for i in z.infolist()]
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def _assert_trees_equal(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    return got


def _config(raw, out, weights="unused", **flags):
    """tests/test_pipeline_stages456.py's config (with its ontology and
    annotation under ``raw``'s parent) and the given FLAGS."""
    assets = os.path.dirname(raw)
    return {
        "raw_location": raw,
        "output_location": out,
        "mask_detection": {
            "output_location": "01_mask_detection/output/",
            "downsample_steps": {
                "original_um_x": 6.25, "original_um_y": 6.25, "original_um_z": 12.5,
                "downsample_um_x": 25.0, "downsample_um_y": 25.0,
                "downsample_um_z": 25.0,
            },
            "mask_with_Ilastik": False,
            "simple_threshold_value": 250,
        },
        "blob_detection": {
            "input_location": "01_mask_detection/output/",
            "model_location": weights,
            "output_location": "02_blob_detection/output/",
            "window_dimensions": {f"window_dim_{i}": 16 for i in range(3)},
        },
        "postprocessing": {
            "input_location": "02_blob_detection/output/",
            "output_location": "03_postprocessing/output/",
        },
        "atlas_alignment": {
            "input_location": "03_postprocessing/output/",
            "output_location": "04_atlas_alignment/output/",
            "collection_folder": "04_atlas_alignment/collection/",
        },
        "region_assignment": {
            "input_location": "04_atlas_alignment/collection/",
            "CCF3_atlasfile": os.path.join(assets, "CCF3_annotation.tif"),
            "CCF3_ontology": os.path.join(assets, "ontology.xml"),
            "output_location": "05_region_assignment/",
        },
        "visualization": {
            "input_csv_location": "05_region_assignment/",
            "input_size_location": "03_postprocessing/output/",
            "input_prediction_location": "02_blob_detection/output/",
            "cache_location": os.path.join(out, "06_visualization/cache"),
            "output_location": "06_visualization/output/",
            "region_id_rgb": True,
            "region_id_grayvalues": True,
        },
        "FLAGS": {"TEST_TIME_AUGMENTATION": False, **flags},
    }


def _run_both(raw_cfg_of, tmp):
    """The same config through the JAX runner and the port's (device cpu):
    (JAX cfg, port cfg, JAX stdout, port stdout)."""
    jcfg = JaxPipelineConfig.from_dict(raw_cfg_of(str(tmp / "out_jax")))
    cfg = PipelineConfig.from_dict(raw_cfg_of(str(tmp / "out_port")))
    j_out = _capture(jax_run_pipeline, jcfg)
    p_out = _capture(run_pipeline, cfg, device="cpu")
    return jcfg, cfg, j_out, p_out


# ---------------- the HOOK protocol ----------------


def test_hook_protocol_format():
    lines = []
    for emitter in (HookEmitter, JaxHookEmitter):
        buf = io.StringIO()
        h = emitter(n_stages=3, stream=buf)
        h.overall()
        h.begin_stage()
        h.item(0, 2)
        h.item(1, 2)
        h.begin_stage()
        h.item(0, 1)
        lines.append(buf.getvalue())
    # reference format: __main__.py:85,96
    assert lines[0] == lines[1] == "HOOK:OVERALL:3\nHOOK:1:3:0:2\nHOOK:1:3:1:2\nHOOK:2:3:0:1\n"


# ---------------- stages 1-3 (tests/test_pipeline_e2e.py) ----------------


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner_e2e")
    raw = str(tmp / "raw")
    _make_blob_brain(os.path.join(raw, "brainA"))
    sd = init_state_dict(BasicUNetConfig(features=TINY), torch.Generator().manual_seed(0))
    weights = str(tmp / "weights.npz")
    save_params_npz(weights, torch_state_dict_to_params(sd))

    def raw_cfg(out):
        c = _config(raw, out, weights, ATLAS_ALIGNMENT=False, REGION_ASSIGNMENT=False,
                    VISUALIZATION=False, SAVE_ACTIVATED_OUTPUT=True)
        # no re-mask erosion: the default 30 planes would empty this 8-plane
        # brain, and stage 3 would compare two empty tables
        c["blob_detection"]["erosion_iters"] = 0
        return c

    return (*_run_both(raw_cfg, tmp), tmp)


def test_e2e_hook_lines_match_jax(e2e):
    _, _, j_out, p_out = e2e[:4]
    assert _hooks(p_out) == _hooks(j_out) == [
        "HOOK:OVERALL:3", "HOOK:1:3:0:1", "HOOK:2:3:0:1", "HOOK:3:3:0:1"]


def test_e2e_stage1_files_match_jax(e2e):
    jcfg, cfg = e2e[:2]
    got = _assert_trees_equal(cfg.mask_detection.output_location,
                              jcfg.mask_detection.output_location)
    assert os.path.join("brainA", "masked_niftis", "masked_nifti.npy") in got


def test_e2e_stage2_binaries_match_jax(e2e):
    jcfg, cfg = e2e[:2]

    def outputs(c):
        d = os.path.join(c.blob_detection.output_location, "brainA", "binary_segmentations")
        return (np.load(os.path.join(d, "binaries.npy")),
                np.load(os.path.join(d, "network_output.npy")), sorted(os.listdir(d)))

    (j_bin, j_sig, j_names), (p_bin, p_sig, p_names) = outputs(jcfg), outputs(cfg)
    assert p_names == j_names == ["binaries.npy", "network_output.npy"]
    assert p_bin.shape == RAW_SHAPE and p_bin.dtype == np.uint8
    np.testing.assert_allclose(p_sig, j_sig, atol=1e-4)
    logit = np.log(np.clip(j_sig, 1e-12, None)) - np.log(np.clip(1 - j_sig, 1e-12, None))
    outside = np.abs(logit) > BAND
    np.testing.assert_array_equal(p_bin[outside], j_bin[outside])


def test_e2e_stage3_files_match_jax(e2e):
    jcfg, cfg = e2e[:2]
    d = os.path.join("brainA", "binary_segmentations", "binaries.npy")
    if not np.array_equal(np.load(os.path.join(cfg.blob_detection.output_location, d)),
                          np.load(os.path.join(jcfg.blob_detection.output_location, d))):
        pytest.fail("stage 2 binaries differ inside the band; stage 3 cannot be compared")
    got = _assert_trees_equal(cfg.postprocessing.output_location,
                              jcfg.postprocessing.output_location)
    assert f"{RAW_SHAPE}_brainA.csv" in got


def test_e2e_rerun_skips_like_jax(e2e):
    jcfg, cfg, _, _, tmp = e2e
    p_out = _capture(run_pipeline, cfg, device="cpu")
    j_out = _capture(jax_run_pipeline, jcfg)
    assert "exists, skipping..." in p_out
    assert "already processed, skipping..." in p_out
    assert _hooks(p_out) == _hooks(j_out)


# ---------------- stages 3-6 (tests/test_pipeline_stages456.py) ----------------


@pytest.fixture(scope="module")
def full456(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner456")
    raw = str(tmp / "raw")
    _make_bright_brain(os.path.join(raw, "mouseQ"))
    atlas = np.ones(HALF_GRID, np.uint16)  # Isocortex
    atlas[:100] = 2  # front: CA1
    write_tiff_stack(str(tmp / "CCF3_annotation.tif"), atlas, compress=True)
    (tmp / "ontology.xml").write_text(ONTOLOGY_XML)

    def raw_cfg(out):
        c = _config(raw, out, BLOB_DETECTION=False)
        _make_binaries(os.path.join(out, "02_blob_detection", "output", "mouseQ",
                                    "binary_segmentations", "binaries.npy"), BLOBS)
        return c

    return _run_both(raw_cfg, tmp)


def test_stages456_hook_lines_match_jax(full456):
    _, _, j_out, p_out = full456
    assert _hooks(p_out) == _hooks(j_out) == [
        "HOOK:OVERALL:5", *(f"HOOK:{i}:5:0:1" for i in range(1, 6))]


@pytest.mark.parametrize("stage", ["mask_detection", "postprocessing", "atlas_alignment",
                                   "collection", "region_assignment", "visualization"])
def test_stages456_files_match_jax(full456, stage):
    jcfg, cfg = full456[:2]

    def where(c):
        if stage == "collection":
            return c.atlas_alignment.collection_folder
        return getattr(c, stage).output_location

    got = _assert_trees_equal(where(cfg), where(jcfg))
    assert got
    if stage == "region_assignment":  # three cells in two regions
        text = got["cells_mouseQ.csv"].decode()
        assert text.count("\n") == 4 and "CA1" in text and "Isocortex" in text
    if stage == "visualization":
        assert len([k for k in got if "_rgb_tiffs" in k]) == 3 * RAW_SHAPE[0]
        assert len([k for k in got if "_region_id_tiffs" in k]) == RAW_SHAPE[0]


# ---------------- cleanup, options, tracing ----------------


def test_save_flags_clean_up_like_jax(tmp_path):
    raw = str(tmp_path / "raw")
    _make_bright_brain(os.path.join(raw, "mouseQ"))

    def raw_cfg(out):
        c = _config(raw, out, BLOB_DETECTION=False, ATLAS_ALIGNMENT=False,
                    REGION_ASSIGNMENT=False, VISUALIZATION=False,
                    SAVE_MASK_OUTPUT=False, SAVE_POSTPROCESSING_OUTPUT=False)
        _make_binaries(os.path.join(out, "02_blob_detection", "output", "mouseQ",
                                    "binary_segmentations", "binaries.npy"), BLOBS)
        return c

    jcfg, cfg, _, _ = _run_both(raw_cfg, tmp_path)
    for c in (jcfg, cfg):
        assert not os.path.exists(c.mask_detection.output_location)
        assert not os.path.exists(c.postprocessing.output_location)
        assert os.path.exists(c.atlas_alignment.output_location)
    assert sorted(_tree(str(tmp_path / "out_port"))) == sorted(_tree(str(tmp_path / "out_jax")))


def test_dcn_slices_above_one_raises_before_any_output(tmp_path):
    """dcn_slices 2 is ported now: on the one CPU device the runner logs the
    JAX runner's warning and runs undistributed
    (tests/test_torch_stage02_sharded.py distributes over CPU meshes)."""
    raw = str(tmp_path / "raw")
    os.makedirs(raw)
    c = _config(raw, str(tmp_path / "out"), MASK_DOWNSAMPLE=False, POSTPROCESSING=False,
                ATLAS_ALIGNMENT=False, REGION_ASSIGNMENT=False, VISUALIZATION=False)
    c["blob_detection"]["dcn_slices"] = 2
    out = _capture(run_pipeline, PipelineConfig.from_dict(c), device="cpu")
    assert "WARNING: dcn_slices=2 but only 1 devices — running undistributed" in out
    assert "DELIVR Done." in out


def test_without_a_card_the_runner_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    raw = str(tmp_path / "raw")
    os.makedirs(raw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pipeline(PipelineConfig.from_dict(_config(raw, str(tmp_path / "out"))))
    assert not os.path.exists(tmp_path / "out")


def _micro_brain(raw):
    """tests/test_cli.py's brain: 12 planes of (32, 32) at 300."""
    os.makedirs(raw)
    for z in range(12):
        write_tiff(os.path.join(raw, f"Z{z:04d}.tif"), np.full((32, 32), 300, np.uint16))


ONLY_STAGE1 = dict(BLOB_DETECTION=False, POSTPROCESSING=False, ATLAS_ALIGNMENT=False,
                   REGION_ASSIGNMENT=False, VISUALIZATION=False)


def test_trace_dir_writes_a_trace(tmp_path, monkeypatch):
    raw = str(tmp_path / "raw")
    _micro_brain(os.path.join(raw, "brainA"))
    monkeypatch.setenv("DELIVR_TRACE_DIR", str(tmp_path / "trace"))
    run_pipeline(PipelineConfig.from_dict(_config(raw, str(tmp_path / "out"),
                                                  **ONLY_STAGE1)), device="cpu")
    (name,) = os.listdir(tmp_path / "trace")
    assert name.startswith(f"trace_{os.getpid()}_") and name.endswith(".json")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "mask_downsample" for e in events)


# ---------------- the CLI (tests/test_cli.py) ----------------


def _write_cli_config(tmp_path, flags):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_config(str(tmp_path / "raw") + "/",
                                       str(tmp_path / "out") + "/", **flags)))
    return path


def test_cli_main_runs_stages_and_emits_hooks(tmp_path):
    cfg_path = _write_cli_config(tmp_path, ONLY_STAGE1)
    _micro_brain(str(tmp_path / "raw" / "brainA"))
    out = _capture(main, [str(cfg_path), "--device", "cpu"])
    assert f"Loading {cfg_path}" in out
    assert _hooks(out) == ["HOOK:OVERALL:1", "HOOK:1:1:0:1"]
    assert os.path.isdir(tmp_path / "out" / "01_mask_detection" / "output")
    assert os.path.isdir(tmp_path / "out" / "05_region_assignment")


def test_cli_default_config_warning(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs(tmp_path / "raw")
    _write_cli_config(tmp_path, {**ONLY_STAGE1, "MASK_DOWNSAMPLE": False})
    out = _capture(main, ["--device", "cpu"])
    assert "internal default config" in out and _hooks(out) == ["HOOK:OVERALL:0"]


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg_path = _write_cli_config(tmp_path, ONLY_STAGE1)
    _micro_brain(str(tmp_path / "raw" / "brainA"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(cfg_path)])


def test_python_m_matches_the_jax_cli(tmp_path):
    """``python -m delivr_cfos_tpu_torch config.json --device cpu`` in a
    fresh interpreter prints the JAX CLI's HOOK lines and writes its
    stage-1 files."""
    _micro_brain(str(tmp_path / "raw" / "brainA"))
    port_cfg = _write_cli_config(tmp_path, ONLY_STAGE1)
    res = subprocess.run([sys.executable, "-m", "delivr_cfos_tpu_torch", str(port_cfg),
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    os.replace(tmp_path / "out", tmp_path / "out_port")
    j_out = _capture(jax_main, [str(port_cfg)])
    assert _hooks(res.stdout) == _hooks(j_out) == ["HOOK:OVERALL:1", "HOOK:1:1:0:1"]
    _assert_trees_equal(str(tmp_path / "out_port"), str(tmp_path / "out"))


# ---------------- a failed stage 2 must not look finished ----------------

REAL = (40, 44, 40)  # 5 window rows at (16, 16, 16): 100 windows, 4 in-memory batches
PADDED = (48, 48, 40)


@pytest.fixture(scope="module")
def masked_brain(tmp_path_factory):
    """A raw stack (header only: the stack shape) and stage 1's padded
    masked volume, with .npz weights."""
    tmp = tmp_path_factory.mktemp("failed_stage2")
    for z in range(REAL[0]):
        os.makedirs(tmp / "raw" / "brain", exist_ok=True)
        write_tiff(str(tmp / "raw" / "brain" / f"Z{z:04d}.tif"),
                   np.zeros(REAL[1:], np.uint16))
    vol = np.zeros(PADDED, np.uint16)
    vol[: REAL[0], : REAL[1], : REAL[2]] = (
        np.random.default_rng(3).random(REAL) * 600 + 5).astype(np.uint16)
    d = tmp / "mask" / "brain" / "masked_niftis"
    os.makedirs(d)
    np.save(d / "masked_nifti.npy", vol[None, None])
    sd = init_state_dict(BasicUNetConfig(features=TINY), torch.Generator().manual_seed(1))
    save_params_npz(str(tmp / "w.npz"), torch_state_dict_to_params(sd))

    def cfg(out, load_all_ram):
        c = _config(str(tmp / "raw"), str(tmp / out), str(tmp / "w.npz"),
                    LOAD_ALL_RAM=load_all_ram, **{**ONLY_STAGE1, "BLOB_DETECTION": True,
                                                  "MASK_DOWNSAMPLE": False})
        c["blob_detection"]["input_location"] = str(tmp / "mask")
        c["blob_detection"]["erosion_iters"] = 2
        return PipelineConfig.from_dict(c)

    return cfg


@pytest.mark.parametrize("load_all_ram", [True, False], ids=["in_memory", "streamed"])
def test_a_failed_stage2_runs_again(masked_brain, monkeypatch, load_all_ram):
    """The forward raises at its second batch (in slab 0 when streamed,
    before any chunk or resume sidecar is written). The brain keeps a
    binaries.npy and no sidecar, which the JAX runner's skip check takes as
    finished (``delivr_cfos_tpu/pipeline/runner.py:144``), and the marker,
    which the port's does not: the next run_pipeline runs inference again,
    and its binaries equal a clean run's."""
    tag = "mem" if load_all_ram else "stream"
    clean = masked_brain(f"clean_{tag}", load_all_ram)
    run_pipeline(clean, device="cpu")
    binaries = os.path.join("brain", "binary_segmentations", "binaries.npy")
    want = np.load(os.path.join(clean.blob_detection.output_location, binaries))
    assert int(want.sum()) > 0

    cfg = masked_brain(f"failed_{tag}", load_all_ram)
    real = basic_unet.basic_unet_apply
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("forward failed")
        return real(*args, **kw)

    monkeypatch.setattr(basic_unet, "basic_unet_apply", failing)
    with pytest.raises(RuntimeError, match="forward failed"):
        run_pipeline(cfg, device="cpu")
    monkeypatch.setattr(basic_unet, "basic_unet_apply", real)
    session = os.path.join(cfg.blob_detection.output_location, "brain")
    seg = os.path.join(session, "binary_segmentations")
    # what the JAX runner reads as a finished brain: binaries, no sidecar
    assert os.path.exists(os.path.join(seg, "binaries.npy"))
    assert not os.path.exists(os.path.join(seg, "streaming_resume.json"))
    assert os.path.exists(os.path.join(seg, IN_PROGRESS)) and not inference_done(session)

    out = _capture(run_pipeline, cfg, device="cpu")
    assert "already processed" not in out
    assert inference_done(session) and not os.path.exists(os.path.join(seg, IN_PROGRESS))
    np.testing.assert_array_equal(
        np.load(os.path.join(cfg.blob_detection.output_location, binaries)), want)
    assert "already processed, skipping..." in _capture(run_pipeline, cfg, device="cpu")
