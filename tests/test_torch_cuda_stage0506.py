"""Stages 5 and 6 on the card against the same functions on the CPU.

Neither stage runs a hand-written kernel: the heatmap's counts and blur
(``ops/gaussian.py``) and the per-label lookup (``ops/lut.py``) are plain
torch. The blur rounds each float64 operation alone, in scipy's order, and
the counts are integers, so the card's heatmap equals the CPU's bit for bit;
the lookup is a gather. So every file that the entry points write must be
byte-equal between the card and the CPU (the .xlsx zips member by member:
the zip stamps each member with the clock's time).

These tests carry the ``cuda`` marker, skip where there is no card, and
import neither JAX nor the JAX package (run without tests/conftest.py on a
GPU machine):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_stage0506.py
"""

import os
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import synthetic_annotation, synthetic_ontology_xml
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.ops.gaussian import gaussian_filter_reflect, scatter_counts
from delivr_cfos_tpu_torch.ops.lut import apply_lut
from delivr_cfos_tpu_torch.pipeline.stage03_count_blobs import count_blobs
from delivr_cfos_tpu_torch.pipeline.stage05_region_assignment import map_cells_to_atlas
from delivr_cfos_tpu_torch.pipeline.stage06_visualization import blob_highlighter
from delivr_cfos_tpu_torch.utils.io.npy import open_memmap
from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff_stack

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".xlsx"):
                with zipfile.ZipFile(path) as z:
                    out[rel] = [(i.filename, z.read(i)) for i in z.infolist()]
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 9, 3), (40, 61, 33), (120, 140, 90)])
def test_gaussian_filter_reflect_equals_the_cpu(dev, shape):
    rng = np.random.default_rng(sum(shape))
    vol = (rng.random(shape) * 50).astype(np.float32)
    cpu = gaussian_filter_reflect(torch.from_numpy(vol), 2.25).numpy()
    card = gaussian_filter_reflect(torch.from_numpy(vol).to(dev), 2.25).cpu().numpy()
    np.testing.assert_array_equal(card.view(np.uint32), cpu.view(np.uint32))


def test_scatter_counts_equals_the_cpu(dev):
    rng = np.random.default_rng(1)
    shape = (60, 70, 50)
    z, y, x = (rng.integers(0, s, 200_000) for s in shape)
    cpu = scatter_counts(shape, z, y, x, "cpu")
    card = scatter_counts(shape, z, y, x, dev)
    np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())
    assert float(card.sum()) == 200_000


@pytest.mark.parametrize("kind", ["rgb", "uint16"])
def test_apply_lut_equals_numpy(dev, kind):
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 5000, (16, 120, 90)).astype(np.int32)
    lut = (rng.integers(0, 256, (5000, 3)).astype(np.uint8) if kind == "rgb"
           else rng.integers(0, 65536, 5000).astype(np.uint16))
    got = apply_lut(labels, lut, dev)
    assert got.dtype == lut.dtype
    np.testing.assert_array_equal(got, lut[labels])


def _collection(path, rng, n):
    x, y, z = rng.uniform(0, 264, n), rng.uniform(0, 160, n), rng.uniform(0, 228, n)
    with open(path, "w") as f:
        f.write("# registration_mode: fallback\nn type x y z Size\n")
        f.writelines(f"{i} 1 {x[i]:.3f} {y[i]:.3f} {z[i]:.3f} {i % 50 + 1}\n"
                     for i in range(n))


def test_map_cells_to_atlas_equals_the_cpu(dev, tmp_path):
    """At the CCF3 grid, 20 000 cells, a 1328-structure ontology."""
    (tmp_path / "ontology.xml").write_text(synthetic_ontology_xml())
    write_tiff_stack(str(tmp_path / "annotation.tif"), synthetic_annotation(), compress=True)
    os.makedirs(tmp_path / "collection")
    rng = np.random.default_rng(3)
    for mouse in ("m1", "m2"):
        os.makedirs(tmp_path / "raw" / mouse)
        _collection(tmp_path / "collection" / f"{mouse}_local.csv", rng, 20_000)

    def cfg(out):
        return PipelineConfig.from_dict({
            "raw_location": str(tmp_path / "raw"), "output_location": str(tmp_path),
            "atlas_alignment": {"collection_folder": "collection"},
            "region_assignment": {"CCF3_atlasfile": str(tmp_path / "annotation.tif"),
                                  "CCF3_ontology": str(tmp_path / "ontology.xml"),
                                  "output_location": out},
        })

    map_cells_to_atlas(cfg("card"), device=None)
    map_cells_to_atlas(cfg("cpu"), device="cpu")
    card, cpu = _tree(tmp_path / "card"), _tree(tmp_path / "cpu")
    assert sorted(card) == sorted(cpu) and len(card) == 2 * 4 + 3
    for name in cpu:
        assert card[name] == cpu[name], name


@pytest.mark.parametrize("depthmap", [False, True], ids=["regions", "depthmap"])
def test_blob_highlighter_equals_the_cpu(dev, tmp_path, depthmap):
    shape = (40, 150, 120)
    rng = np.random.default_rng(4)
    vol = np.zeros(shape, np.uint8)
    for _ in range(400):
        z, y, x = (int(rng.integers(0, s)) for s in shape)
        vol[z : z + 3, y : y + 4, x : x + 4] = 1
    seg = tmp_path / "blob" / "b" / "binary_segmentations"
    os.makedirs(seg)
    mm = open_memmap(str(seg / "binaries.npy"), shape=shape, dtype=np.uint8)
    mm[:] = vol
    mm.flush()
    del mm
    post = str(tmp_path / "post") + os.sep
    count_blobs(PipelineConfig.from_dict({"postprocessing": {"output_location": post},
                                          "FLAGS": {"ABSPATHS": True}}),
                str(tmp_path / "blob"), 0, "b", (1, 1, *shape))
    n = int([f for f in os.listdir(post) if f.endswith("-cc3d.npy")][0].rsplit("-", 2)[-2])
    os.makedirs(tmp_path / "regions")
    pd.DataFrame({
        "connected_component_id": np.arange(1, n + 1), "acronym": "R",
        "red": rng.integers(1, 256, n), "green": rng.integers(0, 256, n),
        "blue": rng.integers(0, 256, n), "graph_order": rng.integers(1, 1328, n),
    }).to_csv(tmp_path / "regions" / "cells_b.csv")
    os.makedirs(tmp_path / "mask" / "b")
    ds = np.zeros((9, 10, 8), np.uint8)
    ds[1:8, 2:9, 1:7] = 100
    write_tiff_stack(str(tmp_path / "mask" / "b" / "downsampled_masked_stack.tif"), ds)

    def cfg(out):
        return PipelineConfig.from_dict({
            "mask_detection": {"output_location": str(tmp_path / "mask")},
            "postprocessing": {"output_location": post},
            "visualization": {
                "input_csv_location": str(tmp_path / "regions"),
                "input_prediction_location": str(tmp_path / "blob"),
                "cache_location": str(tmp_path / f"vcache_{out}"),
                "output_location": str(tmp_path / out),
                "region_id_grayvalues": True, "no_atlas_depthmap": depthmap,
            },
            "FLAGS": {"ABSPATHS": True},
        })

    blob_highlighter(cfg("card"), "b", (1, 1, *shape))
    blob_highlighter(cfg("cpu"), "b", (1, 1, *shape), device="cpu")
    card, cpu = _tree(tmp_path / "card"), _tree(tmp_path / "cpu")
    assert sorted(card) == sorted(cpu) and len(card) == (1 if depthmap else 4) * shape[0]
    assert card == cpu
