"""The port's stage 5 (region tables and heatmaps) against the JAX package's,
on the CPU.

- ``ops/gaussian.py``: ``gaussian_filter_reflect`` equals
  ``scipy.ndimage.gaussian_filter`` bit for bit (no tolerance), on axes
  shorter and longer than the radius of 9 at σ = 2.25; ``scatter_counts``
  equals ``np.add.at`` exactly.
- ``map_cells_to_atlas(cfg, device="cpu")`` against the JAX package's on
  the same collection CSVs, synthetic ontology and annotation: every CSV,
  the heatmap TIFFs and the pickled heatmaps byte for byte; each .xlsx's
  zip members byte for byte, in order (the zip stamps each member with the
  clock's time, so two writes a second apart differ in those bytes).
"""

import os
import pickle
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.ndimage import gaussian_filter

from chip_smoke import synthetic_annotation, synthetic_ontology_xml
from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.pipeline import stage05_region_assignment as jax_stage05
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.ops.gaussian import (
    gaussian_filter_reflect,
    gaussian_weights,
    scatter_counts,
)
from delivr_cfos_tpu_torch.pipeline import stage05_region_assignment as stage05
from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff_stack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRID = (40, 48, 36)  # a small annotation grid: the CCF chain drops what falls outside


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 5), (9, 1, 4), (7, 9, 8),
                                   (10, 19, 20), (23, 31, 17)])
@pytest.mark.parametrize("kind", ["counts", "uniform"])
def test_gaussian_filter_reflect_equals_scipy(shape, kind):
    rng = np.random.default_rng(sum(shape))
    if kind == "counts":
        vol = np.zeros(shape, np.float32)
        np.add.at(vol, tuple(rng.integers(0, s, 60) for s in shape), 1.0)
    else:
        vol = (rng.random(shape) * 100).astype(np.float32)
    want = gaussian_filter(vol, sigma=2.25)
    got = gaussian_filter_reflect(torch.from_numpy(vol.copy()), 2.25).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("sigma", [0.6, 1.0, 3.7])
def test_gaussian_filter_reflect_other_sigmas(sigma):
    vol = (np.random.default_rng(3).random((12, 30, 5)) * 7).astype(np.float32)
    got = gaussian_filter_reflect(torch.from_numpy(vol.copy()), sigma).numpy()
    np.testing.assert_array_equal(got, gaussian_filter(vol, sigma=sigma))


def test_gaussian_weights_are_scipys():
    from scipy.ndimage._filters import _gaussian_kernel1d

    w = gaussian_weights(2.25)
    assert len(w) == 19
    np.testing.assert_array_equal(w, _gaussian_kernel1d(2.25, 0, 9))


def test_scatter_counts_equals_add_at():
    rng = np.random.default_rng(0)
    shape = (13, 17, 11)
    z, y, x = (rng.integers(0, s, 5000) for s in shape)
    want = np.zeros(shape, np.float32)
    np.add.at(want, (z, y, x), 1.0)
    got = scatter_counts(shape, z, y, x, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _collection_csv(path, rng, n, mode="fallback"):
    """A stage-4 collection CSV of ``n`` cells in 50 µm atlas coordinates,
    most of which land in GRID through the CCF chain
    (ccf z = 2z, y = 2·(264 − x), x = 2·(160 − y))."""
    x = np.round(rng.uniform(264 - GRID[1] / 2 - 2, 264.4, n), 3)
    y = np.round(rng.uniform(160 - GRID[2] / 2 - 2, 160.4, n), 3)
    z = np.round(rng.uniform(-0.4, GRID[0] / 2 + 1, n), 3)
    size = rng.integers(1, 40, n)
    with open(path, "w") as f:
        f.write(f"# registration_mode: {mode}\n")
        f.write("n type x y z Size\n")
        for i in range(n):
            f.write(f"{i} 1 {x[i]} {y[i]} {z[i]} {size[i]}\n")


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


@pytest.fixture(scope="module")
def atlas_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage05")
    (tmp / "ontology.xml").write_text(synthetic_ontology_xml(40, seed=4))
    write_tiff_stack(str(tmp / "annotation.tif"),
                     synthetic_annotation(GRID, 40, seed=4, block=4), compress=True)
    rng = np.random.default_rng(11)
    collection = tmp / "collection"
    os.makedirs(collection)
    for mouse, n in (("mouseA", 300), ("mouseB", 2)):
        os.makedirs(tmp / "raw" / mouse)
        _collection_csv(collection / f"{mouse}_local_registered_with_original_size.csv",
                        rng, n)
    os.makedirs(tmp / "raw" / "mouseC")  # no collection CSV: skipped
    return tmp


def _raw_cfg(tmp, out, **post):
    return {
        "raw_location": str(tmp / "raw"),
        "output_location": str(tmp),
        "postprocessing": post,
        "atlas_alignment": {"collection_folder": "collection"},
        "region_assignment": {
            "CCF3_atlasfile": str(tmp / "annotation.tif"),
            "CCF3_ontology": str(tmp / "ontology.xml"),
            "output_location": out,
        },
    }


@pytest.mark.parametrize("post", [{}, {"min_size": 5, "max_size": 30}])
def test_map_cells_to_atlas_matches_jax(atlas_inputs, post):
    tag = "sized" if post else "all"
    jcfg = JaxPipelineConfig.from_dict(_raw_cfg(atlas_inputs, f"jax_{tag}", **post))
    jax_stage05.map_cells_to_atlas(jcfg)
    cfg = PipelineConfig.from_dict(_raw_cfg(atlas_inputs, f"port_{tag}", **post))
    steps = stage05.map_cells_to_atlas(cfg, device="cpu")
    assert {"read_atlas", "tables", "heatmap", "write_heatmap",
            "write_collection"} <= set(steps)
    want = _tree(jcfg.region_assignment.output_location)
    got = _tree(cfg.region_assignment.output_location)
    assert sorted(got) == sorted(want) and len(want) == 2 * 4 + 3
    for name in want:
        assert got[name] == want[name], name
    cells = pd.read_csv(os.path.join(cfg.region_assignment.output_location,
                                     "cells_mouseA.csv"), index_col=0)
    assert 100 < len(cells) < 300  # some cells fall outside GRID
    assert (cells["acronym"] != "bgr").sum() > 0
    with open(os.path.join(cfg.region_assignment.output_location,
                           "heatmap_collection.pickledump"), "rb") as f:
        heatmaps = pickle.load(f)
    assert sorted(heatmaps) == ["mouseA", "mouseB"]
    np.testing.assert_allclose(heatmaps["mouseA"].sum(), len(cells), rtol=1e-3)


def test_create_heatmap_matches_jax():
    rng = np.random.default_rng(7)
    shape = (23, 31, 17)
    cells = pd.DataFrame({k: rng.integers(0, s, 40) for k, s in zip("zyx", shape)})
    want = jax_stage05.create_heatmap(cells, shape)
    got = stage05.create_heatmap(cells, shape, "cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_map_cells_to_atlas_without_a_card_raises(atlas_inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = PipelineConfig.from_dict(_raw_cfg(atlas_inputs, "nocuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stage05.map_cells_to_atlas(cfg)


def test_collapse_to_color_group_matches_rowwise_reference():
    """The port's groupby collapse reproduces the reference's row-wise scan
    (cells_to_atlas.py:92-112) column for column, including the
    acronym→name ``to_string`` quirk when an acronym recurs (mirror of
    tests/test_pipeline_stages456.py)."""
    ontology = pd.DataFrame(
        {
            "acronym": ["root", "ISO", "CA1", "CA2", "DUP", "DUP"],
            "name": ["root", "Isocortex", "Field CA1", "Field CA2",
                     "dup one", "dup two"],
            "color-hex-triplet": ["FFFFFF", "70FF71", "7ED04B", "7ED04B",
                                  "AA0000", "AA0000"],
        }
    )
    elements = pd.DataFrame(
        {
            "color-hex-triplet": ["70FF71", "7ED04B", "7ED04B", "AA0000"],
            "number": [3, 5, 2, 7],
        }
    )

    def rowwise(elements, ontology_df):
        tmp = pd.DataFrame(elements)
        groups = pd.DataFrame(
            columns=["ColorGroup", "GroupName", "GroupAcronym",
                     "GroupedAcronyms", "BlobCount"]
        )
        groups["ColorGroup"] = ontology_df["color-hex-triplet"].unique().tolist()
        for i in range(len(groups)):
            color = groups.at[i, "ColorGroup"]
            acronyms = ontology_df[
                ontology_df["color-hex-triplet"] == color
            ]["acronym"].tolist()
            groups.at[i, "GroupedAcronyms"] = ", ".join(acronyms)
            groups.at[i, "GroupName"] = (
                ontology_df[ontology_df["acronym"] == acronyms[0]]["name"]
                .to_string(index=False)
                .strip()
            )
            groups.at[i, "GroupAcronym"] = acronyms[0]
            if len(tmp):
                groups.at[i, "BlobCount"] = tmp[
                    tmp["color-hex-triplet"] == color
                ]["number"].sum()
            else:
                groups.at[i, "BlobCount"] = 0
        return groups

    for elems in (elements, elements.iloc[:0]):
        got = stage05.collapse_to_color_group(elems, ontology)
        want = rowwise(elems, ontology)
        assert list(got.columns) == list(want.columns)
        for col in want.columns:
            assert got[col].astype(str).tolist() == want[col].astype(str).tolist(), col
