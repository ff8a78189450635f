"""The port's stage-2 entry against the JAX package's on one synthetic
masked volume with the same .npz weights (parity mode on the CPU, both).

Binaries must be equal wherever the JAX mean logit lies outside the parity
band (|logit| > 1e-3: the f32 outputs agree to ~1e-4, so only voxels at the
sigmoid cut may fall either way); the test reports how many lie inside."""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.models.convert import save_params_npz, torch_state_dict_to_params
from delivr_cfos_tpu.pipeline.stage02_inference import run_inference as jax_run
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    init_state_dict,
)
from delivr_cfos_tpu_torch.pipeline.stage02_inference import (
    resolve_model_config,
    run_inference,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
REAL = (14, 44, 40)
PADDED = (16, 48, 40)
BAND = 1e-3  # |logit| inside which parity runs may disagree at the cut


@pytest.fixture(scope="module")
def brain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage02")
    rng = np.random.default_rng(3)
    vol = np.zeros(PADDED, np.uint16)
    vol[: REAL[0], : REAL[1], : REAL[2]] = (
        rng.random(REAL) * 600 + 5
    ).astype(np.uint16)
    d = tmp / "in" / "brain" / "masked_niftis"
    os.makedirs(d)
    np.save(d / "masked_nifti.npy", vol[None, None])
    sd = init_state_dict(BasicUNetConfig(features=TINY), torch.Generator().manual_seed(1))
    weights = tmp / "w.npz"
    save_params_npz(str(weights), torch_state_dict_to_params(sd))

    def raw(out, **bd):
        return {
            "output_location": str(tmp),
            "blob_detection": {
                "input_location": "in/",
                "model_location": str(weights),
                "output_location": out,
                "window_dimensions": {f"window_dim_{i}": 16 for i in range(3)},
                "erosion_iters": 2,
                **bd,
            },
            "FLAGS": {"TEST_TIME_AUGMENTATION": False, "SAVE_ACTIVATED_OUTPUT": True},
        }

    return raw


def _outputs(session):
    d = os.path.join(session, "binary_segmentations")
    return np.load(os.path.join(d, "binaries.npy")), np.load(
        os.path.join(d, "network_output.npy")
    )


def test_run_inference_matches_jax(brain):
    stack = (1, 1, *REAL)
    j_bin, j_sig = _outputs(jax_run(JaxPipelineConfig.from_dict(brain("jax/")), "brain", stack))
    sidecar = os.path.join(
        PipelineConfig.from_dict(brain("port/")).blob_detection.output_location,
        "brain", "binary_segmentations", "streaming_resume.json",
    )
    os.makedirs(os.path.dirname(sidecar))
    open(sidecar, "w").close()
    session = run_inference(PipelineConfig.from_dict(brain("port/")), "brain",
                            stack, device="cpu")
    p_bin, p_sig = _outputs(session)
    assert not os.path.exists(sidecar)
    assert p_bin.shape == j_bin.shape == REAL and p_bin.dtype == j_bin.dtype == np.uint8
    np.testing.assert_allclose(p_sig, j_sig, atol=1e-4)
    logit = np.log(np.clip(j_sig, 1e-12, None)) - np.log(np.clip(1 - j_sig, 1e-12, None))
    outside = np.abs(logit) > BAND
    print(f"voxels inside the ±{BAND} logit band: {int((~outside).sum())}")
    assert int(j_bin.sum()) > 0
    np.testing.assert_array_equal(p_bin[outside], j_bin[outside])


def test_config_parses_like_the_jax_package(brain, tmp_path):
    """Every section, stages 5-6 and ``dcn_slices`` included: the same
    settings after path resolution, and the same folder tree."""
    raw = brain("cfg/", precision="fast", spatial_shards=1, dcn_slices=2)
    raw["mask_detection"] = {"output_location": "masks/", "ingest_threads": 3}
    raw["region_assignment"] = {"input_location": "04/collection/",
                                "CCF3_atlasfile": "/atlas/annotation.tif",
                                "CCF3_ontology": "ontology.xml", "output_location": "05/"}
    raw["visualization"] = {"input_csv_location": "05/", "cache_location": "/cache",
                            "output_location": "06/out/", "region_id_grayvalues": True,
                            "no_atlas_depthmap": True, "unknown_key": 1}
    ours, theirs = PipelineConfig.from_dict(raw), JaxPipelineConfig.from_dict(raw)
    assert ours.to_settings_dict() == theirs.to_settings_dict()
    assert dataclasses.asdict(ours.blob_detection) == dataclasses.asdict(theirs.blob_detection)
    assert dataclasses.asdict(ours.region_assignment) == dataclasses.asdict(
        theirs.region_assignment)
    assert dataclasses.asdict(ours.visualization) == dataclasses.asdict(theirs.visualization)
    assert ours.blob_detection.window_dimensions.zyx == (16, 16, 16)
    assert ours.region_assignment.output_location == os.path.join(raw["output_location"], "05/")
    assert ours.visualization.cache_location == "/cache"

    trees = []
    for pkg, name in ((PipelineConfig, "ours"), (JaxPipelineConfig, "theirs")):
        out = tmp_path / name
        pkg.from_dict({**raw, "output_location": str(out)}).setup_folders()
        trees.append(sorted(os.path.relpath(d, out) for d, _, _ in os.walk(out)))
    assert trees[0] == trees[1] and "05" in trees[0]


def test_resolve_model_config_modes():
    sd = init_state_dict(BasicUNetConfig(features=TINY), torch.Generator().manual_seed(0))
    bd = PipelineConfig().blob_detection
    for precision, device, want in [
        ("parity", "cuda", "parity"), ("fast", "cpu", "fast"),
        ("auto", "cpu", "parity"), ("auto", "cuda", "fast"),
    ]:
        cfg, mode = resolve_model_config(
            dataclasses.replace(bd, precision=precision), sd, device
        )
        assert mode == want and cfg.precision == want and cfg.features == TINY
    with pytest.raises(ValueError):
        resolve_model_config(dataclasses.replace(bd, precision="bogus"), sd, "cpu")


def test_streaming_and_sharded_branches_are_not_ported(brain):
    """Both branches are ported now: with spatial_shards 2 on the one CPU
    device, in memory and streamed, stage 2 logs the JAX package's warning
    and runs single-device, with the outputs of the unsharded run
    (tests/test_torch_stage02_sharded.py shards over CPU meshes)."""
    stack = (1, 1, *REAL)
    for load_all_ram in (True, False):
        runs = []
        for shards in (1, 2):
            raw = brain(f"sharded_{load_all_ram}_{shards}/", spatial_shards=shards)
            raw["FLAGS"]["LOAD_ALL_RAM"] = load_all_ram
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                session = run_inference(PipelineConfig.from_dict(raw), "brain", stack,
                                        device="cpu")
            runs.append((_outputs(session), buf.getvalue()))
        (one_bin, one_sig), _ = runs[0]
        (two_bin, two_sig), out = runs[1]
        assert "WARNING: spatial_shards=2 but only 1 devices — running single-chip" in out
        np.testing.assert_array_equal(two_bin, one_bin)
        np.testing.assert_array_equal(two_sig, one_sig)


def test_cuda_requested_without_a_card_raises(brain):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(PipelineConfig.from_dict(brain("nocuda/")), "brain", (1, 1, *REAL))


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: tests/conftest.py has imported JAX here. Stages
    1-6, their modules, the runner, the CLI, parallel/*, training/*, the
    NIfTI and zarr codecs, window packing, the analysis tools,
    chip_smoke.py and the scripts beside it that drive the card."""
    code = (
        "import sys\n"
        "import delivr_cfos_tpu_torch.pipeline.stage02_inference\n"
        "import delivr_cfos_tpu_torch.models.basic_unet_cs\n"
        "import delivr_cfos_tpu_torch.engine.streaming\n"
        "import delivr_cfos_tpu_torch.ops.instance_norm_mish\n"
        "import delivr_cfos_tpu_torch.ops.deconv2x_cs\n"
        "import delivr_cfos_tpu_torch.pipeline.stage03_count_blobs\n"
        "import delivr_cfos_tpu_torch.ops.connected_components\n"
        "import delivr_cfos_tpu_torch.native.cc\n"
        "import delivr_cfos_tpu_torch.pipeline.stage01_downsample_mask\n"
        "import delivr_cfos_tpu_torch.models.ilastik_import\n"
        "import delivr_cfos_tpu_torch.native.tiff\n"
        "import delivr_cfos_tpu_torch.pipeline.stage04_atlas_align\n"
        "import delivr_cfos_tpu_torch.registration\n"
        "import delivr_cfos_tpu_torch.registration.validate\n"
        "import delivr_cfos_tpu_torch.utils.io.nrrd\n"
        "import delivr_cfos_tpu_torch.__main__\n"
        "import delivr_cfos_tpu_torch.pipeline.runner\n"
        "import delivr_cfos_tpu_torch.pipeline.stage05_region_assignment\n"
        "import delivr_cfos_tpu_torch.pipeline.stage06_visualization\n"
        "import delivr_cfos_tpu_torch.utils.profiling\n"
        "import delivr_cfos_tpu_torch.analysis.ontology\n"
        "import delivr_cfos_tpu_torch.utils.io.xlsx\n"
        "import delivr_cfos_tpu_torch.parallel\n"
        "import delivr_cfos_tpu_torch.parallel.mesh\n"
        "import delivr_cfos_tpu_torch.parallel.sharded_inference\n"
        "import delivr_cfos_tpu_torch.parallel.sharded_cc\n"
        "import delivr_cfos_tpu_torch.parallel.sharded_training\n"
        "import delivr_cfos_tpu_torch.training\n"
        "import delivr_cfos_tpu_torch.training.losses\n"
        "import delivr_cfos_tpu_torch.training.data\n"
        "import delivr_cfos_tpu_torch.training.train\n"
        "import delivr_cfos_tpu_torch.utils.io.nifti\n"
        "import delivr_cfos_tpu_torch.utils.io.zarr\n"
        "import delivr_cfos_tpu_torch.models.packing\n"
        "import delivr_cfos_tpu_torch.analysis.depth_profile\n"
        "import delivr_cfos_tpu_torch.analysis.group_stats\n"
        "import delivr_cfos_tpu_torch.analysis.elastix_points\n"
        "import delivr_cfos_tpu_torch.analysis.brainrender_export\n"
        "import delivr_cfos_tpu_torch.analysis.brainrender_render\n"
        "import delivr_cfos_tpu_torch.analysis.napari_loader\n"
        "import chip_smoke\n"
        "import conv3d_cs_hashes\n"
        "import conv3d_cs_wide_rows\n"
        "import conv3d_cs_wide_variants\n"
        "import nifti_margin_runs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'delivr_cfos_tpu' or m.startswith('delivr_cfos_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_analysis_package_imports_no_pandas():
    """``delivr_cfos_tpu_torch.analysis`` exports the JAX package's three
    names and loads neither pandas, scipy, JAX nor the JAX package: stage 5
    imports its ontology module."""
    code = (
        "import sys\n"
        "from delivr_cfos_tpu_torch.analysis import (\n"
        "    apply_transform_chain, parse_ontology_xml, transform_points_native)\n"
        "import delivr_cfos_tpu_torch.analysis as a\n"
        "assert a.__all__ == ['parse_ontology_xml', 'apply_transform_chain',\n"
        "                     'transform_points_native'], a.__all__\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('pandas', 'scipy', 'jax', 'jaxlib', 'delivr_cfos_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_a_card():
    """Where CUDA is missing the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
