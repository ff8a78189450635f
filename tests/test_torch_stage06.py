"""The port's stage 6 (region-colored RGB stacks, region-id grayvalues,
depth maps) against the JAX package's, on the CPU.

``blob_highlighter(cfg, brain, stack_shape, device="cpu")`` and
``depth_map_blobs`` write every TIFF byte for byte as the JAX package's on
the same binaries and cells CSV: with stage 3's label and statistics caches
and without them (then each package labels, in RAM or out of core into
stage 3's cache names, and those caches are equal too), with LOAD_ALL_RAM on
and off. The JAX side runs its host labelers (``tests/jax_host_labelers.py``).
``ops/lut.py::apply_lut`` equals numpy's indexing exactly, over chunks of
one plane and more.
"""

import dataclasses
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.pipeline import stage06_visualization as jax_stage06
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.ops import lut as lut_mod
from delivr_cfos_tpu_torch.pipeline import stage06_visualization as stage06
from delivr_cfos_tpu_torch.pipeline.stage03_count_blobs import count_blobs
from delivr_cfos_tpu_torch.utils.io.npy import open_memmap
from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff, write_tiff_stack
from jax_host_labelers import jax_host_labelers  # noqa: F401 (autouse)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (12, 40, 36)  # (z, y, x) of the raw stack and its binaries
BRAIN = "mouseV"


def _binaries(seed=2):
    rng = np.random.default_rng(seed)
    vol = np.zeros(SHAPE, np.uint8)
    for _ in range(25):
        z, y, x = (int(rng.integers(0, s)) for s in SHAPE)
        dz, dy, dx = (int(v) for v in rng.integers(1, 5, 3))
        vol[z : z + dz, y : y + dy, x : x + dx] = 1
    return vol


def _cells_csv(path, n, seed=3):
    """A stage-5 cells table: most components get a region (colors, graph
    order), some rows are background ('bgr', dropped), one names a
    component past n (ignored)."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.permutation(np.arange(1, n + 1))[: max(1, n - 3)], [n + 5]])
    k = len(ids)
    df = pd.DataFrame({
        "connected_component_id": ids,
        "x": rng.integers(0, 300, k), "y": rng.integers(0, 500, k),
        "z": rng.integers(0, 400, k), "Size": rng.integers(1, 60, k),
        "acronym": np.where(rng.random(k) < 0.2, "bgr", "R"),
        "red": rng.integers(1, 256, k), "green": rng.integers(0, 256, k),
        "blue": rng.integers(0, 256, k), "graph_order": rng.integers(1, 1300, k),
    })
    df.to_csv(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Raw TIFF names (for the stack shape), binaries, stage-3 caches (from
    the port's stage 3, equal to the JAX package's), the cells CSV and
    stage 1's downsampled masked stack."""
    tmp = tmp_path_factory.mktemp("stage06")
    seg = tmp / "blob" / BRAIN / "binary_segmentations"
    os.makedirs(seg)
    mm = open_memmap(str(seg / "binaries.npy"), shape=SHAPE, dtype=np.uint8)
    mm[:] = _binaries()
    mm.flush()
    del mm
    cache = str(tmp / "cache") + os.sep
    count_blobs(PipelineConfig.from_dict({
        "postprocessing": {"output_location": cache}, "FLAGS": {"ABSPATHS": True},
    }), str(tmp / "blob"), 0, BRAIN, (1, 1, *SHAPE))
    n = int([f for f in os.listdir(cache) if f.endswith("-cc3d.npy")][0].rsplit("-", 2)[-2])
    assert n > 10
    os.makedirs(tmp / "regions")
    _cells_csv(tmp / "regions" / f"cells_{BRAIN}.csv", n)
    mask = tmp / "mask" / BRAIN
    os.makedirs(mask)
    ds = np.zeros((3, 10, 9), np.uint8)
    ds[:, 2:9, 1:8] = 200
    write_tiff_stack(str(mask / "downsampled_masked_stack.tif"), ds)
    return tmp


def _cfg(pkg, tmp, tag, caches, load_all_ram, depthmap):
    post = tmp / f"post_{tag}"
    if caches:
        shutil.copytree(tmp / "cache", post)
    return pkg.from_dict({
        "mask_detection": {
            "output_location": str(tmp / "mask"),
            "downsample_steps": {"original_um_x": 6.25, "original_um_y": 6.25,
                                 "original_um_z": 12.5},
        },
        "postprocessing": {"output_location": str(post) + os.sep},
        "visualization": {
            "input_csv_location": str(tmp / "regions"),
            "input_prediction_location": str(tmp / "blob"),
            "cache_location": str(tmp / f"vcache_{tag}"),
            "output_location": str(tmp / f"viz_{tag}"),
            "region_id_rgb": True,
            "region_id_grayvalues": True,
            "no_atlas_depthmap": depthmap,
        },
        "FLAGS": {"ABSPATHS": True, "LOAD_ALL_RAM": load_all_ram},
    })


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


@pytest.mark.parametrize("depthmap", [False, True], ids=["regions", "depthmap"])
@pytest.mark.parametrize("load_all_ram", [True, False], ids=["ram", "out_of_core"])
@pytest.mark.parametrize("caches", [True, False], ids=["caches", "no_caches"])
def test_blob_highlighter_matches_jax(inputs, caches, load_all_ram, depthmap):
    tag = f"{caches}_{load_all_ram}_{depthmap}"
    jcfg = _cfg(JaxPipelineConfig, inputs, f"jax_{tag}", caches, load_all_ram, depthmap)
    jax_stage06.blob_highlighter(jcfg, BRAIN, (1, 1, *SHAPE))
    cfg = _cfg(PipelineConfig, inputs, f"port_{tag}", caches, load_all_ram, depthmap)
    steps = stage06.blob_highlighter(cfg, BRAIN, (1, 1, *SHAPE), device="cpu")
    assert {"label_load", "lut_gather", "write"} <= set(steps)
    want = _tree(jcfg.visualization.output_location)
    got = _tree(cfg.visualization.output_location)
    n_files = SHAPE[0] if depthmap else 4 * SHAPE[0]
    assert sorted(got) == sorted(want) and len(got) == n_files
    for name in want:
        assert got[name] == want[name], name
    # the labeling without caches leaves the same stage-3 caches behind
    assert _tree(cfg.postprocessing.output_location) == _tree(
        jcfg.postprocessing.output_location)
    assert not os.path.exists(os.path.join(cfg.visualization.cache_location, BRAIN))
    if not depthmap:  # some voxel is colored
        rgb = os.path.join(cfg.visualization.output_location, f"{BRAIN}_rgb_tiffs")
        assert any(read_tiff(os.path.join(rgb, f)).any() for f in os.listdir(rgb))


def test_depth_map_blobs_matches_jax(inputs):
    jcfg = _cfg(JaxPipelineConfig, inputs, "jax_dm", True, True, True)
    jax_stage06.depth_map_blobs(jcfg, BRAIN, (1, 1, *SHAPE))
    cfg = _cfg(PipelineConfig, inputs, "port_dm", True, True, True)
    stage06.depth_map_blobs(cfg, BRAIN, (1, 1, *SHAPE), device="cpu")
    want = _tree(jcfg.visualization.output_location)
    assert len(want) == SHAPE[0] and _tree(cfg.visualization.output_location) == want


def test_a_missing_cells_csv_raises_as_in_jax(inputs, tmp_path):
    cfg = _cfg(PipelineConfig, inputs, "nocsv", True, True, False)
    viz = dataclasses.replace(cfg.visualization, input_csv_location=str(tmp_path))
    with pytest.raises(IndexError):
        stage06.blob_highlighter(dataclasses.replace(cfg, visualization=viz), BRAIN,
                                 (1, 1, *SHAPE), device="cpu")


@pytest.mark.parametrize("planes", [1, 5, 100])
@pytest.mark.parametrize("dtype", ["rgb", "uint16"])
def test_apply_lut_equals_numpy_over_chunks(monkeypatch, planes, dtype):
    rng = np.random.default_rng(planes)
    labels = rng.integers(0, 70, (9, 11, 7)).astype(np.int32)
    lut = (rng.integers(0, 256, (70, 3)).astype(np.uint8) if dtype == "rgb"
           else rng.integers(0, 65536, 70).astype(np.uint16))
    per_plane = 11 * 7 * (4 + lut[:1].nbytes)
    monkeypatch.setattr(lut_mod, "_CHUNK_BYTES", planes * per_plane)
    step = lut_mod.lut_chunk_planes((11, 7), lut, "cpu")
    assert step == planes
    got = np.concatenate([lut_mod.apply_lut(labels[z : z + step], lut, "cpu")
                          for z in range(0, 9, step)])
    assert got.dtype == lut.dtype
    np.testing.assert_array_equal(got, lut[labels])


def test_blob_highlighter_without_a_card_raises(inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = _cfg(PipelineConfig, inputs, "nocuda", True, True, False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stage06.blob_highlighter(cfg, BRAIN, (1, 1, *SHAPE))
