"""The port's stage-2 entry against the JAX package's on one synthetic
masked volume with the same .npz weights (parity mode on the CPU, both).

Binaries must be equal wherever the JAX mean logit lies outside the parity
band (|logit| > 1e-3: the f32 outputs agree to ~1e-4, so only voxels at the
sigmoid cut may fall either way); the test reports how many lie inside."""

import dataclasses
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


def test_config_parses_like_the_jax_package(brain):
    raw = brain("cfg/", precision="fast", spatial_shards=1)
    raw["mask_detection"] = {"output_location": "masks/", "ingest_threads": 3}
    ours, theirs = PipelineConfig.from_dict(raw), JaxPipelineConfig.from_dict(raw)
    assert dataclasses.asdict(ours.blob_detection) == {
        k: v for k, v in dataclasses.asdict(theirs.blob_detection).items()
        if k != "dcn_slices"
    }
    assert dataclasses.asdict(ours.FLAGS) == dataclasses.asdict(theirs.FLAGS)
    assert dataclasses.asdict(ours.mask_detection) == dataclasses.asdict(theirs.mask_detection)
    assert ours.blob_detection.window_dimensions.zyx == (16, 16, 16)


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
    """Only the sharded branch is left unported: the streaming branch runs
    (tests/test_torch_streaming.py holds it against the JAX package), and
    spatial_shards > 1 raises before any output is made, with or without
    LOAD_ALL_RAM."""
    stack = (1, 1, *REAL)
    for load_all_ram in (True, False):
        sharded = brain(f"sharded_{load_all_ram}/", spatial_shards=2)
        sharded["FLAGS"]["LOAD_ALL_RAM"] = load_all_ram
        cfg = PipelineConfig.from_dict(sharded)
        with pytest.raises(NotImplementedError, match="Multi-GPU"):
            run_inference(cfg, "brain", stack, device="cpu")
        assert not os.path.exists(cfg.blob_detection.output_location)


def test_cuda_requested_without_a_card_raises(brain):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(PipelineConfig.from_dict(brain("nocuda/")), "brain", (1, 1, *REAL))


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: tests/conftest.py has imported JAX here. Stages
    1-3, their modules, and chip_smoke.py."""
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
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'delivr_cfos_tpu' or m.startswith('delivr_cfos_tpu.')]\n"
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
