"""Stage 2 and the runner over several devices in the port: spatial sharding
through ``blob_detection.spatial_shards`` and a caller's mesh, the
``dcn_slices`` brain distribution, and a two-process gloo run, on meshes of
CPU devices (the counterpart of the JAX tests' eight virtual devices).

Mirrors tests/test_stage02_sharded.py (binaries of 4 shards equal to one
device's on an awkward (70, 32, 32) volume, in memory and streamed) and
tests/test_dcn_brain_distribution.py (the JAX runner's log lines; binaries
equal to the undistributed run's), with the same log lines as the JAX
package's where it decides the same way.
"""

import contextlib
import io
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from delivr_cfos_tpu.models.convert import save_params_npz, torch_state_dict_to_params
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig, init_state_dict
from delivr_cfos_tpu_torch.parallel.mesh import make_mesh
from delivr_cfos_tpu_torch.pipeline.runner import run_pipeline
from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference
from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff
from torch_dist_worker import run_rank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
MODEL_CFG = BasicUNetConfig(features=TINY)
ROI = (16, 16, 16)
CPUS = ["cpu"] * 8


@pytest.fixture(scope="module")
def sd():
    return init_state_dict(MODEL_CFG, torch.Generator().manual_seed(5))


def _capture(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


# ---------------- stage 2 ----------------


def _write_brain(root, vol):
    d = os.path.join(root, "mask", "mouse", "masked_niftis")
    os.makedirs(d)
    np.save(os.path.join(d, "masked_nifti.npy"), vol[None, None])
    return os.path.join(root, "mask")


def _stage2_cfg(mask_root, blob_root, shards, load_all_ram):
    return PipelineConfig.from_dict({
        "blob_detection": {
            "input_location": mask_root,
            "output_location": blob_root,
            "spatial_shards": shards,
            "window_dimensions": {f"window_dim_{i}": ROI[i] for i in range(3)},
        },
        "FLAGS": {"ABSPATHS": True, "LOAD_ALL_RAM": load_all_ram,
                  "SAVE_ACTIVATED_OUTPUT": True, "TEST_TIME_AUGMENTATION": False},
    })


@pytest.fixture(scope="module")
def awkward():
    rng = np.random.default_rng(4)
    vol = np.zeros((70, 32, 32), np.uint16)  # awkward z on purpose
    vol[:66, :28, :30] = (rng.random((66, 28, 30)) * 700 + 5).astype(np.uint16)
    return vol, (1, 1, 66, 28, 30)


def _stage2(tmp_path, name, vol, stack, sd, shards, load_all_ram, **kw):
    """(binaries, sigmoid outputs, log) of one run_inference on the CPU."""
    root = str(tmp_path / name)
    cfg = _stage2_cfg(_write_brain(root, vol), os.path.join(root, "blob"), shards, load_all_ram)
    out = _capture(run_inference, cfg, "mouse", stack, params=sd, model_cfg=MODEL_CFG,
                   device="cpu", **kw)
    d = os.path.join(root, "blob", "mouse", "binary_segmentations")
    return np.load(os.path.join(d, "binaries.npy")), np.load(
        os.path.join(d, "network_output.npy")), out


@pytest.mark.parametrize("load_all_ram", [True, False])
def test_stage02_sharded_matches_single_device(sd, tmp_path, awkward, load_all_ram):
    vol, stack = awkward
    one_bin, one_sig, _ = _stage2(tmp_path, "s1", vol, stack, sd, 1, load_all_ram,
                                  devices=CPUS)
    bins, sig, out = _stage2(tmp_path, "s4", vol, stack, sd, 4, load_all_ram, devices=CPUS)
    assert "Spatial sharding over 4 chips" in out
    assert bins.shape == stack[2:] and int(one_bin.sum()) > 0
    np.testing.assert_array_equal(bins, one_bin)
    np.testing.assert_allclose(sig, one_sig, atol=1e-5)


def test_stage02_more_shards_than_devices_runs_on_one(sd, tmp_path, awkward):
    """JAX's documented config behaviour: a warning, then the one device
    runs every window."""
    vol, stack = awkward
    one_bin, _, _ = _stage2(tmp_path, "s1", vol, stack, sd, 1, True)
    bins, _, out = _stage2(tmp_path, "s4", vol, stack, sd, 4, True, devices=["cpu"])
    assert "WARNING: spatial_shards=4 but only 1 devices — running single-chip" in out
    assert "Spatial sharding" not in out
    np.testing.assert_array_equal(bins, one_bin)


def test_stage02_caller_mesh(sd, tmp_path, awkward):
    """A caller's mesh of several devices shards whatever spatial_shards
    says; one of a single device means no sharding."""
    vol, stack = awkward
    one_bin, _, _ = _stage2(tmp_path, "s1", vol, stack, sd, 1, False)
    bins, _, out = _stage2(tmp_path, "mesh4", vol, stack, sd, 1, False,
                           mesh=make_mesh({"sp": 4}, devices=CPUS))
    assert "Spatial sharding over caller mesh (4 chips)" in out
    np.testing.assert_array_equal(bins, one_bin)
    bins, _, out = _stage2(tmp_path, "mesh1", vol, stack, sd, 4, True,
                           mesh=make_mesh({"sp": 1}, devices=["cpu"]))
    assert "Spatial sharding" not in out and "WARNING" not in out
    np.testing.assert_array_equal(bins, one_bin)


# ---------------- the runner: dcn_slices ----------------

REAL_SHAPE = (16, 32, 32)


@pytest.fixture(scope="module")
def brains(tmp_path_factory, sd):
    """tests/test_dcn_brain_distribution.py's three brains and weights."""
    tmp = tmp_path_factory.mktemp("dcn")
    rng = np.random.default_rng(5)
    for b in range(3):
        real = (rng.random(REAL_SHAPE) * 200 + 10).astype(np.uint16)
        real[4:7, 10:16, 10:16] = 40000 + b
        d = tmp / "in" / f"brain{b}" / "masked_niftis"
        os.makedirs(d)
        np.save(d / "masked_nifti.npy", real[None, None])
        os.makedirs(tmp / "raw" / f"brain{b}")
        for z in range(REAL_SHAPE[0]):
            write_tiff(str(tmp / "raw" / f"brain{b}" / f"Z{z:04d}.tif"), real[z])
    weights = tmp / "w.npz"
    save_params_npz(str(weights), torch_state_dict_to_params(sd))

    def cfg(out_name, dcn_slices):
        return {
            "raw_location": str(tmp / "raw"),
            "output_location": str(tmp),
            "blob_detection": {
                "input_location": "in/",
                "model_location": str(weights),
                "output_location": out_name,
                "window_dimensions": {f"window_dim_{i}": 16 for i in range(3)},
                "dcn_slices": dcn_slices,
            },
            "FLAGS": {"TEST_TIME_AUGMENTATION": False, "MASK_DOWNSAMPLE": False,
                      "POSTPROCESSING": False, "ATLAS_ALIGNMENT": False,
                      "REGION_ASSIGNMENT": False, "VISUALIZATION": False},
        }

    def binaries(out_name, b):
        return np.load(tmp / out_name / f"brain{b}" / "binary_segmentations" / "binaries.npy")

    plain = "out_plain/"
    run_pipeline(PipelineConfig.from_dict(cfg(plain, 1)), device="cpu", devices=CPUS)
    return cfg, binaries, plain


def test_brains_distribute_over_two_slices(brains):
    cfg, binaries, plain = brains
    out = _capture(run_pipeline, PipelineConfig.from_dict(cfg("out_dcn/", 2)),
                   device="cpu", devices=CPUS)
    assert "Distributing 3 brains over 2 DCN slices (4 chips each)" in out
    assert "brain0 → DCN slice 0" in out
    assert "brain1 → DCN slice 1" in out
    assert "brain2 → DCN slice 0" in out
    assert out.count("Spatial sharding over caller mesh (4 chips)") == 3
    for b in range(3):
        assert binaries("out_dcn/", b).shape == REAL_SHAPE
        np.testing.assert_array_equal(binaries("out_dcn/", b), binaries(plain, b))


def test_too_few_devices_runs_undistributed(brains):
    cfg, binaries, plain = brains
    out = _capture(run_pipeline, PipelineConfig.from_dict(cfg("out_64/", 64)),
                   device="cpu", devices=CPUS)
    assert "WARNING: dcn_slices=64 but only 8 devices — running undistributed" in out
    for b in range(3):
        np.testing.assert_array_equal(binaries("out_64/", b), binaries(plain, b))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_share_the_brains(brains, tmp_path):
    """Two ranks of a gloo group on localhost, one CPU device each,
    ``dcn_slices`` 2: each brain runs in exactly one process (0, 1, 0), and
    every binaries.npy equals the one-process run's."""
    cfg, binaries, plain = brains
    mp.spawn(run_rank, args=(cfg("out_mp/", 2), _free_port(), str(tmp_path)), nprocs=2,
             join=True)
    logs = [open(tmp_path / f"rank{r}.log").read() for r in range(2)]
    for r, log in enumerate(logs):
        assert f"torch.distributed initialized: process {r}/2" in log
        assert "Distributing 3 brains over 2 DCN slices (1 chips each)" in log
    ran = [[b for b in range(3) if f"brain{b} → DCN slice" in log] for log in logs]
    assert ran == [[0, 2], [1]]
    assert "brain1 assigned to another slice/host, skipping..." in logs[0]
    for b in range(3):
        np.testing.assert_array_equal(binaries("out_mp/", b), binaries(plain, b))
