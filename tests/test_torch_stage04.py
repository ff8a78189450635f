"""The port's stage 4 (pipeline/stage04_atlas_align.py) against the JAX
package's on the CPU, in its three registration modes:

- fallback (no template), on tests/test_pipeline_stages456.py's layout
  (stage 1 and stage 3 of the port on its raw brain and binaries): every
  SWC, both collection CSVs and the transform.npz arrays equal byte for
  byte;
- landmarks (marker files, no template), on the same layout: the same;
- template (the synthetic atlas of registration/validate.py as .nrrd, a
  fixed brain made from it through a known affine, the default config:
  multistart, NCC, dense, FFD at spacing 16): the same mode and files of the
  same rows, the warped coordinates within TEMPLATE_TOL atlas voxels of
  JAX's (the two optimizers round Adam's update in other orders; measured:
  at most 0.001, one unit of the CSV's third decimal).

The port writes its tables without pandas; the SWC and CSV writers are held
to pandas' bytes here too.
"""

import dataclasses
import io
import os

import numpy as np
import pandas as pd
import pytest
import torch

from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.pipeline.stage04_atlas_align import (
    parse_blob_csv as jax_parse_blob_csv,
    run_registration_and_point_warp as jax_stage4,
)
from delivr_cfos_tpu.registration.swc import (
    swc_frame_from_cells as jax_swc_frame,
    write_swc as jax_write_swc,
)
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.pipeline.stage01_downsample_mask import downsample_mask
from delivr_cfos_tpu_torch.pipeline.stage03_count_blobs import count_blobs, write_blob_csv
from delivr_cfos_tpu_torch.pipeline.stage04_atlas_align import (
    crop_trailing_zeros,
    parse_blob_csv,
    run_registration_and_point_warp,
)
from delivr_cfos_tpu_torch.registration.swc import read_swc, swc_frame_from_cells, write_swc
from delivr_cfos_tpu_torch.registration.validate import (
    affine_transform_fn,
    apply_transform_volume,
    make_synthetic_atlas,
)
from delivr_cfos_tpu_torch.utils.io.npy import open_memmap
from delivr_cfos_tpu_torch.utils.io.nrrd import write_nrrd
from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff_stack
from delivr_cfos_tpu_torch.utils.io.v3draw import write_v3draw
from test_pipeline_stages456 import RAW_SHAPE, _make_raw_brain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BRAIN = "mouseQ"
TEMPLATE_TOL = 0.01  # atlas voxels, template mode, port against JAX
OUT_NAME = f"{BRAIN}_local_registered_with_original_size.csv"


def _raw_config(root, atlas_alignment=None):
    """tests/test_pipeline_stages456.py's config for stages 1-4 under ``root``."""
    return {
        "raw_location": os.path.join(root, "raw"),
        "output_location": os.path.join(root, "out"),
        "mask_detection": {
            "output_location": "01_mask_detection/output/",
            "downsample_steps": {
                "original_um_x": 6.25, "original_um_y": 6.25, "original_um_z": 12.5,
                "downsample_um_x": 25.0, "downsample_um_y": 25.0, "downsample_um_z": 25.0,
            },
            "mask_with_Ilastik": False,
            "simple_threshold_value": 250,
        },
        "blob_detection": {"output_location": "02_blob_detection/output/"},
        "postprocessing": {"input_location": "02_blob_detection/output/",
                           "output_location": "03_postprocessing/output/"},
        "atlas_alignment": {
            "input_location": "03_postprocessing/output/",
            "output_location": "04_atlas_alignment/output/",
            "collection_folder": "04_atlas_alignment/collection/",
            **(atlas_alignment or {}),
        },
    }


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Stage 1 and stage 3 of the port on test_pipeline_stages456's raw
    brain and pre-seeded binaries; returns (root, stage-3 CSV path)."""
    root = str(tmp_path_factory.mktemp("stage4"))
    _make_raw_brain(os.path.join(root, "raw", BRAIN))
    cfg = PipelineConfig.from_dict(_raw_config(root))
    downsample_mask(cfg, BRAIN, device="cpu")
    seg = np.zeros(RAW_SHAPE, np.uint8)
    for z, y, x in [(2, 20, 20), (4, 30, 25), (5, 40, 30), (6, 50, 35)]:
        seg[z - 1: z + 1, y - 2: y + 2, x - 2: x + 2] = 1
    bin_dir = os.path.join(cfg.blob_detection.output_location, BRAIN, "binary_segmentations")
    os.makedirs(bin_dir)
    mm = open_memmap(os.path.join(bin_dir, "binaries.npy"), shape=RAW_SHAPE, dtype=np.uint8)
    mm[:] = seg
    mm.flush()
    del mm
    csv = count_blobs(cfg, cfg.blob_detection.output_location, 0, BRAIN, (1, 1, *RAW_SHAPE))
    return root, csv


def _outputs(cfg):
    """{name: bytes} of stage 4's SWC and CSV files, and transform.npz's arrays."""
    aa = cfg.atlas_alignment
    out_dir = os.path.join(aa.output_location, BRAIN)
    files = {n: open(os.path.join(out_dir, n), "rb").read()
             for n in sorted(os.listdir(out_dir)) if n != "transform.npz"}
    files["collection/" + OUT_NAME] = open(
        os.path.join(aa.collection_folder, OUT_NAME), "rb").read()
    with np.load(os.path.join(out_dir, "transform.npz")) as tr:
        arrays = {k: tr[k] for k in tr.files}
    return files, arrays


def _both(root, csv, tag, atlas_alignment=None):
    """Stage 4 of both packages on ``csv`` into ``tag``-named outputs."""
    outs = []
    for pkg, config, run in (("port", PipelineConfig, run_registration_and_point_warp),
                             ("jax", JaxPipelineConfig, jax_stage4)):
        raw = _raw_config(root, {
            "output_location": f"04_{tag}_{pkg}/output/",
            "collection_folder": f"04_{tag}_{pkg}/collection/",
            **(atlas_alignment or {})})
        cfg = config.from_dict(raw)
        if pkg == "port":
            steps = run(cfg, csv, device="cpu")
            assert {"load", "crop", "template", "point_warp", "write"} <= set(steps)
        else:
            run(cfg, csv)
        outs.append(_outputs(cfg))
    return outs


def _assert_arrays_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_fallback_mode_matches_jax_byte_for_byte(layout):
    root, csv = layout
    (port_files, port_arrays), (jax_files, jax_arrays) = _both(root, csv, "fallback")
    assert port_files == jax_files
    _assert_arrays_equal(port_arrays, jax_arrays)
    assert bytes(port_arrays["mode"]) == b"fallback"
    text = port_files[OUT_NAME].decode()
    assert text.startswith("# registration_mode: fallback\nn type x y z Size\n0 1 ")
    assert text.count("\n") == 2 + 3  # the reference's range(1, N) drops the 4th blob


def _markers(root):
    """Brain-space landmarks and their atlas-space partners through an
    affine with non-integer terms, as Vaa3D .marker (x, y, z, 1-based) and
    as z,y,x CSV."""
    rng = np.random.default_rng(8)
    src = rng.uniform(0, 16, (10, 3)).round(2)
    A = np.array([[5.1, 0.2, -0.1, 3.3], [0.15, 2.4, 0.3, -1.7], [-0.05, 0.1, 4.9, 2.2]])
    dst = src @ A[:, :3].T + A[:, 3] + rng.normal(0, 0.05, src.shape)
    brain = os.path.join(root, "brain.marker")
    with open(brain, "w") as f:
        f.write("##x,y,z,radius,shape,name,comment\n")
        for z, y, x in src:
            f.write(f"{x + 1},{y + 1},{z + 1},1,1,L,\n")
    atlas = os.path.join(root, "atlas.csv")
    with open(atlas, "w") as f:
        f.write("z,y,x\n" + "".join(f"{z},{y},{x}\n" for z, y, x in dst))
    return brain, atlas


def test_landmark_mode_matches_jax_byte_for_byte(layout):
    """The least-squares affine is numpy in both packages; the float32 warp
    of (N, 3) @ (3, 3) gives the same bits here (measured), so the files are
    equal."""
    root, csv = layout
    brain, atlas = _markers(root)
    aa = {"landmarks_hemisphere": True, "landmarks_file": brain, "atlas_landmarks_file": atlas}
    (port_files, port_arrays), (jax_files, jax_arrays) = _both(root, csv, "landmarks", aa)
    assert bytes(port_arrays["mode"]) == b"landmarks"
    assert port_files == jax_files
    _assert_arrays_equal(port_arrays, jax_arrays)


def _collection(text: bytes):
    return pd.read_csv(io.BytesIO(text), sep=" ", comment="#")


def test_template_mode_matches_jax(tmp_path):
    """A fixed brain made from a (26, 22, 30) synthetic atlas through a
    rotation, scale and translation, written as stage 1's v3draw with
    trailing zero padding; 41 cells in a stage-3 CSV of a raw brain twice
    the stack's size; the atlas as .nrrd; the default registration config."""
    root = str(tmp_path)
    atlas, _ = make_synthetic_atlas((26, 22, 30), n_regions=8, seed=2)
    th = 0.1
    A = np.zeros((3, 4), np.float32)
    A[:, :3] = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)], [0, np.sin(th), np.cos(th)]]
                        ) @ np.diag([1.05, 0.95, 1.04])
    A[:, 3] = [1.0, 1.5, -1.0]
    fixed = apply_transform_volume(atlas, (24, 24, 28), affine_transform_fn(A, "cpu"),
                                   device="cpu")
    stack = np.zeros((30, 32, 36), np.uint8)  # stage 1's trailing padding
    stack[:24, :24, :28] = np.clip(fixed, 0, 255).astype(np.uint8)
    mask_dir = os.path.join(root, "out", "01_mask_detection", "output", BRAIN)
    os.makedirs(mask_dir)
    write_v3draw(os.path.join(mask_dir, "stack_masked_downsampled.v3draw"), stack)
    write_tiff_stack(os.path.join(mask_dir, "stack_resampled.tif"), stack[:24, :24, :28])
    rng = np.random.default_rng(4)
    centroids = np.concatenate([np.full((1, 3), np.nan),
                                rng.uniform(4, 20, (41, 3)) * [2.0, 2.0, 2.0]])
    post = os.path.join(root, "out", "03_postprocessing", "output")
    os.makedirs(post)
    csv = os.path.join(post, f"(48, 48, 56)_{BRAIN}.csv")
    write_blob_csv(csv, {"centroids": centroids,
                         "voxel_counts": rng.integers(2, 90, 42)}, 42)
    template = os.path.join(root, "atlas.nrrd")
    write_nrrd(template, atlas)
    (port_files, port_arrays), (jax_files, jax_arrays) = _both(
        root, csv, "template", {"template_file": template})
    assert bytes(port_arrays["mode"]) == bytes(jax_arrays["mode"]) == b"intensity-ncc"
    assert port_files.keys() == jax_files.keys()
    assert port_files[f"{BRAIN}_resampled.swc"] == jax_files[f"{BRAIN}_resampled.swc"]
    np.testing.assert_array_equal(port_arrays["fixed_shape"], jax_arrays["fixed_shape"])
    assert port_arrays["ffd_ctrl"].shape == jax_arrays["ffd_ctrl"].shape == (5, 5, 5, 3)
    for name in (OUT_NAME, "collection/" + OUT_NAME):
        port, jax = _collection(port_files[name]), _collection(jax_files[name])
        assert list(port.columns) == ["n", "type", "x", "y", "z", "Size"]
        assert len(port) == len(jax) == 41
        np.testing.assert_array_equal(port[["n", "type", "Size"]], jax[["n", "type", "Size"]])
        np.testing.assert_allclose(port[["x", "y", "z"]], jax[["x", "y", "z"]], rtol=0,
                                   atol=TEMPLATE_TOL)
    # the registration found the known affine: cells land near their truth
    cells = parse_blob_csv(csv)
    pts = np.stack([cells["z"] / 2, cells["y"] / 2, cells["x"] / 2], 1)
    truth = pts @ A[:, :3].T + A[:, 3]
    port = _collection(port_files[OUT_NAME])[["z", "y", "x"]].to_numpy()
    assert np.linalg.norm(port - truth, axis=1).mean() < 1.0


def test_a_table_without_cells_gives_header_only_outputs(layout):
    """A stage-3 table with no rows (one component or none; the reference
    drops the last): the JAX package's pandas split raises KeyError there,
    and its runner skips the brain; the port writes the files with their
    headers only (ROADMAP.md §3)."""
    root, _ = layout
    csv = os.path.join(root, f"{RAW_SHAPE}_{BRAIN}.csv")
    with open(csv, "w") as f:
        f.write(",Blob,Coords,Size\n")
    raw = _raw_config(root, {"output_location": "04_empty/output/",
                             "collection_folder": "04_empty/collection/"})
    with pytest.raises(KeyError):
        jax_stage4(JaxPipelineConfig.from_dict(raw), csv)
    cfg = PipelineConfig.from_dict(raw)
    run_registration_and_point_warp(cfg, csv, device="cpu")
    files, arrays = _outputs(cfg)
    assert files[OUT_NAME] == b"# registration_mode: fallback\nn type x y z Size\n"
    assert files[f"{BRAIN}_resampled.swc"] == b"##n type x y z radius parent\n"
    assert bytes(arrays["mode"]) == b"fallback"


def test_crop_trailing_zeros():
    vol = np.zeros((6, 7, 8), np.float32)
    vol[1, 2, 3] = vol[3, 4, 5] = 1
    assert crop_trailing_zeros(vol).shape == (4, 5, 6)
    assert crop_trailing_zeros(np.zeros((3, 3, 3))).shape == (3, 3, 3)


def test_parse_blob_csv_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    centroids = np.concatenate([np.full((1, 3), np.nan), rng.uniform(0, 900, (30, 3)),
                                [[1e-05, 0.0, 123456.78949], [2.0005, 7.0, 1 / 3]]])
    path = str(tmp_path / f"(9, 9, 9)_{BRAIN}.csv")
    write_blob_csv(path, {"centroids": centroids, "voxel_counts": np.arange(33) * 7}, 33)
    got = parse_blob_csv(path)
    want = jax_parse_blob_csv(path)
    for k in ("z", "y", "x", "Size"):
        assert got[k].dtype == want[k].to_numpy().dtype
        np.testing.assert_array_equal(got[k], want[k].to_numpy())


def test_swc_writer_gives_pandas_bytes(tmp_path):
    rng = np.random.default_rng(6)
    x, y, z = (rng.normal(0, 300, 50) for _ in range(3))
    x[:4] = [-0.0001, 1e-05, 1e16, 2.0004999]  # -0.0 after rounding, as pandas writes it
    size = rng.integers(1, 500, 50)
    port, jax = str(tmp_path / "port.swc"), str(tmp_path / "jax.swc")
    write_swc(port, swc_frame_from_cells(x, y, z, size))
    jax_write_swc(jax, jax_swc_frame(x, y, z, size))
    assert open(port, "rb").read() == open(jax, "rb").read()
    assert b" -0.0 " in open(port, "rb").read()
    back = read_swc(port)
    want = pd.read_csv(port, sep=" ", skiprows=1,
                       names=["n", "type", "x", "y", "z", "radius", "parent"])
    for k in want.columns:
        assert back[k].dtype == want[k].to_numpy().dtype, k
        np.testing.assert_array_equal(back[k], want[k].to_numpy())


def test_atlas_alignment_config_matches_jax(tmp_path):
    raw = _raw_config(str(tmp_path), {"template_file": "t.nrrd", "ffd_levels": [2, 1],
                                      "similarity": "mi", "n_samples": 4096})
    port = PipelineConfig.from_dict(raw).atlas_alignment
    jax = JaxPipelineConfig.from_dict(raw).atlas_alignment
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert port.collection_folder == os.path.join(str(tmp_path), "out",
                                                  "04_atlas_alignment/collection/")


def test_stage4_without_a_card_raises(layout):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    root, csv = layout
    cfg = PipelineConfig.from_dict(_raw_config(root, {"output_location": "04_nocuda/"}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_registration_and_point_warp(cfg, csv)
    assert not os.path.exists(cfg.atlas_alignment.output_location)

