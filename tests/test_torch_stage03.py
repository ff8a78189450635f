"""The port's stage 3 (pipeline/stage03_count_blobs.py) against the JAX
package's on the same binaries, in its three branches: in RAM with the
native whole-volume engine (cc_workers ≤ 1), in RAM slab-parallel
(cc_workers > 1), and out of core into a memmap (LOAD_ALL_RAM false). The
CSV bytes, the cache file name, the labels and the statistics pickle must be
equal; the port writes the CSV without pandas."""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.pipeline.stage03_count_blobs import count_blobs as jax_count_blobs
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig, init_state_dict
from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference
from delivr_cfos_tpu_torch.pipeline.stage03_count_blobs import (
    count_blobs,
    write_blob_csv,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRANCHES = {"ram_native": (True, 1), "ram_slabs": (True, 3), "out_of_core": (False, 0)}


def _boxes(shape=(60, 32, 32), seed=5):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint8)
    for _ in range(60):
        z, y, x = (rng.integers(0, s) for s in shape)
        dz, dy, dx = rng.integers(1, 6, 3)
        vol[z : z + dz, y : y + dy, x : x + dx] = 1
    vol[:, 20, 20] = 1  # a rod through every z-slab of 64 planes and less
    return vol


def _write_binaries(blob_root, brain, vol):
    seg = os.path.join(blob_root, brain, "binary_segmentations")
    os.makedirs(seg, exist_ok=True)
    np.save(os.path.join(seg, "binaries.npy"), vol)


def _run(pkg_config, count, blob_root, post_root, shape, branch, brain="mouse"):
    """One count_blobs call; returns (CSV bytes, cache file names, labels,
    stats)."""
    load_all_ram, workers = BRANCHES[branch]
    cfg = pkg_config.from_dict({
        "postprocessing": {"output_location": post_root, "cc_workers": workers},
        "FLAGS": {"ABSPATHS": True, "LOAD_ALL_RAM": load_all_ram},
    })
    csv_path = count(cfg, blob_root, 0, brain, (1, 1, *shape))
    assert csv_path == post_root + f"{tuple(shape)}_{brain}.csv"
    with open(csv_path, "rb") as f:
        text = f.read()
    names = sorted(os.listdir(post_root))
    cc3d = [n for n in names if n.endswith("-cc3d.npy")]
    assert len(cc3d) == 1, names
    labels = np.load(os.path.join(post_root, cc3d[0]))
    with open(os.path.join(post_root, f"{brain}-stats.pickle"), "rb") as f:
        stats = pickle.load(f)
    return text, names, labels, stats


def _stats_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_count_blobs_matches_jax(tmp_path, branch):
    vol = _boxes()
    blob = str(tmp_path / "blob")
    _write_binaries(blob, "mouse", vol)
    port = _run(PipelineConfig, count_blobs, blob, str(tmp_path / "port") + os.sep,
                vol.shape, branch)
    jax = _run(JaxPipelineConfig, jax_count_blobs, blob, str(tmp_path / "jax") + os.sep,
               vol.shape, branch)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    np.testing.assert_array_equal(port[2], jax[2])
    _stats_equal(port[3], jax[3])
    assert port[0].startswith(b",Blob,Coords,Size\n0,1,\"[")
    assert port[0].count(b"\n") == int(port[2].max())  # header + rows 1..N-1


def test_branches_agree(tmp_path):
    vol = _boxes(seed=6)
    blob = str(tmp_path / "blob")
    _write_binaries(blob, "mouse", vol)
    runs = [_run(PipelineConfig, count_blobs, blob, str(tmp_path / b) + os.sep,
                 vol.shape, b) for b in sorted(BRANCHES)]
    for r in runs[1:]:
        assert r[0] == runs[0][0] and r[1] == runs[0][1]
        np.testing.assert_array_equal(r[2], runs[0][2])


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("kind", ["empty", "one_blob"])
def test_no_rows_gives_the_header_only(tmp_path, branch, kind):
    """No component, or only one (the reference drops the last), gives the
    header alone, as pandas writes an empty frame."""
    vol = np.zeros((12, 9, 10), np.uint8)
    if kind == "one_blob":
        vol[3:5, 2:4, 4:7] = 1
    blob = str(tmp_path / "blob")
    _write_binaries(blob, "mouse", vol)
    port = _run(PipelineConfig, count_blobs, blob, str(tmp_path / "port") + os.sep,
                vol.shape, branch)
    jax = _run(JaxPipelineConfig, jax_count_blobs, blob, str(tmp_path / "jax") + os.sep,
               vol.shape, branch)
    assert port[0] == jax[0] == b",Blob,Coords,Size\n"
    assert port[1] == jax[1]


def test_cached_labels_and_stats_are_reused(tmp_path, capsys):
    vol = _boxes(seed=7)
    blob = str(tmp_path / "blob")
    _write_binaries(blob, "mouse", vol)
    post = str(tmp_path / "post") + os.sep
    first = _run(PipelineConfig, count_blobs, blob, post, vol.shape, "ram_native")
    capsys.readouterr()
    os.remove(os.path.join(blob, "mouse", "binary_segmentations", "binaries.npy"))
    np.save(os.path.join(blob, "mouse", "binary_segmentations", "binaries.npy"),
            np.zeros_like(vol))  # not read again: the cache answers
    again = _run(PipelineConfig, count_blobs, blob, post, vol.shape, "ram_native")
    assert "Cached labels found" in capsys.readouterr().out
    assert again[0] == first[0] and again[1] == first[1]


def test_csv_writer_gives_pandas_bytes(tmp_path):
    pd = pytest.importorskip("pandas")
    centroids = np.array([[np.nan] * 3, [1.0, 2.5, 3.0], [1e-05, 123456789.5, 0.1],
                          [7.0, 1 / 3, 2.0], [0.0, 0.0, 0.0]])
    stats = {"centroids": centroids, "voxel_counts": np.array([9, 3, 1, 12, 4], np.int64)}
    n = len(centroids) - 1
    idx = np.arange(1, n)
    want = str(tmp_path / "pandas.csv")
    pd.DataFrame(
        {"Blob": idx, "Coords": [centroids[i].tolist() for i in idx],
         "Size": stats["voxel_counts"][idx]},
        index=np.zeros(len(idx), np.int64),
    ).to_csv(want)
    got = str(tmp_path / "port.csv")
    write_blob_csv(got, stats, n)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_postprocessing_config_parses_like_the_jax_package(tmp_path):
    raw = {"output_location": str(tmp_path),
           "postprocessing": {"input_location": "blob/", "output_location": "post/",
                              "min_size": 3, "cc_workers": 2, "unknown": 1}}
    ours, theirs = PipelineConfig.from_dict(raw), JaxPipelineConfig.from_dict(raw)
    assert dataclasses.asdict(ours.postprocessing) == dataclasses.asdict(theirs.postprocessing)
    assert ours.postprocessing.output_location == os.path.join(str(tmp_path), "post/")


def test_stage2_into_stage3_on_the_cpu(tmp_path):
    """The port's stage 2 at TINY features writes binaries.npy; the port's
    stage 3 counts them as the JAX package's does."""
    tiny = (4, 4, 8, 16, 32, 4)
    real, padded = (14, 44, 40), (16, 48, 40)
    rng = np.random.default_rng(3)
    vol = np.zeros(padded, np.uint16)
    vol[: real[0], : real[1], : real[2]] = (rng.random(real) * 600 + 5).astype(np.uint16)
    d = tmp_path / "in" / "brain" / "masked_niftis"
    os.makedirs(d)
    np.save(d / "masked_nifti.npy", vol[None, None])
    sd = init_state_dict(BasicUNetConfig(features=tiny), torch.Generator().manual_seed(1))
    raw = {
        "output_location": str(tmp_path),
        "blob_detection": {
            "input_location": "in/", "output_location": "blob/",
            "window_dimensions": {f"window_dim_{i}": 16 for i in range(3)},
            "erosion_iters": 2,
        },
        "postprocessing": {"output_location": "post/"},
        "FLAGS": {"TEST_TIME_AUGMENTATION": False},
    }
    cfg = PipelineConfig.from_dict(raw)
    run_inference(cfg, "brain", (1, 1, *real), params=sd, device="cpu")
    binaries = np.load(tmp_path / "blob" / "brain" / "binary_segmentations" / "binaries.npy")
    assert binaries.shape == real and binaries.sum() > 0
    csv_path = count_blobs(cfg, cfg.blob_detection.output_location, 0, "brain",
                           (1, 1, *real))
    raw["postprocessing"]["output_location"] = "post_jax/"
    jcfg = JaxPipelineConfig.from_dict(raw)
    jax_path = jax_count_blobs(jcfg, jcfg.blob_detection.output_location, 0, "brain",
                               (1, 1, *real))
    with open(csv_path, "rb") as f, open(jax_path, "rb") as g:
        text = f.read()
        assert text == g.read()
    assert text.startswith(b",Blob,Coords,Size\n")


def test_stage3_imports_no_pandas():
    """The GPU machine has no pandas: in a fresh interpreter, the port's
    stage 3 and labelers import none."""
    code = (
        "import sys\n"
        "import delivr_cfos_tpu_torch.pipeline.stage03_count_blobs\n"
        "import delivr_cfos_tpu_torch.ops.connected_components\n"
        "sys.exit(1 if 'pandas' in sys.modules else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_without_the_native_source_stage3_takes_scipy(tmp_path):
    """An installed copy without native/cc_label.cpp: ``get_library`` returns
    None (hashing the missing source raises inside its ``try``), the native
    labeler answers None, and count_blobs writes the native run's CSV with
    the scipy engine."""
    import shutil

    pkg = tmp_path / "site" / "delivr_cfos_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "delivr_cfos_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "cc_label.cpp"))
    assert not (pkg / "native" / "cc_label.cpp").exists()
    vol = _boxes(seed=8)
    blob = str(tmp_path / "blob")
    _write_binaries(blob, "mouse", vol)
    native = _run(PipelineConfig, count_blobs, blob, str(tmp_path / "native") + os.sep,
                  vol.shape, "ram_native")
    post = str(tmp_path / "scipy") + os.sep
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import delivr_cfos_tpu_torch as port\n"
        "from delivr_cfos_tpu_torch.config import PipelineConfig\n"
        "from delivr_cfos_tpu_torch.native.build import get_library\n"
        "from delivr_cfos_tpu_torch.native.cc import cc_label_native\n"
        "from delivr_cfos_tpu_torch.pipeline.stage03_count_blobs import count_blobs\n"
        f"assert port.__file__.startswith({str(tmp_path)!r}), port.__file__\n"
        "assert get_library() is None\n"
        "assert cc_label_native(np.ones((2, 2, 2), np.uint8)) is None\n"
        "cfg = PipelineConfig.from_dict({'postprocessing': {'output_location': "
        f"{post!r}, 'cc_workers': 1}}, 'FLAGS': {{'ABSPATHS': True, 'LOAD_ALL_RAM': True}}}})\n"
        f"print(count_blobs(cfg, {blob!r}, 0, 'mouse', (1, 1, *{vol.shape!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "site"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert not (tmp_path / "site" / "build").exists()  # nothing was built
    with open(res.stdout.strip().splitlines()[-1], "rb") as f:
        assert f.read() == native[0]
    assert sorted(os.listdir(post)) == native[1]
