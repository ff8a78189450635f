"""Stage 6 — visualization: region-colored RGB stacks, region-id grayvalue
stacks, and no-atlas depth maps.

The counterpart of ``delivr_cfos_tpu/pipeline/stage06_visualization.py``
(reference: blob_highlighter.py:38-172, blob_depthmap.py:115-222), with the
same output contract, byte for byte:

    {viz_output}/{brain}_rgb_tiffs/{brain}rgb_C00_z0000.tif  (+C01/C02 per z)
    {viz_output}/{brain}/{brain}_region_id_tiffs/region_id_0000.tif
    {viz_output}/{brain}/{brain}_depthmap_tiffs/depthmap_0000.tif

Coloring is a per-label lookup table applied to the label volume, as in the
JAX package. The gather, one pass over a raw-resolution volume of about
10^11 voxels, runs on ``device`` over z-chunks sized from its memory
(``ops/lut.py``); the host's thread pool keeps the deflate and the TIFF
writes. Labels and statistics come from stage 3's caches when present,
else from the port's host labelers (in RAM, or out of core into stage 3's
cache names). The depth map's distance transform stays scipy on the host,
as in the JAX package.

Quirks kept for parity: ``bgr`` rows are dropped, a missing cells CSV
raises (IndexError), and the depth map's ``range(N)`` leaves blob N
uncoloured.
"""

from __future__ import annotations

import os
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
from scipy.ndimage import distance_transform_edt

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.native.cc import cc_label_native, cc_statistics_native
from delivr_cfos_tpu_torch.ops.connected_components import (
    component_statistics,
    component_statistics_streaming,
    label_out_of_core,
    label_volume_host,
)
from delivr_cfos_tpu_torch.ops.lut import apply_lut, lut_chunk_planes
from delivr_cfos_tpu_torch.utils.device import StepSeconds, resolve_device, timed
from delivr_cfos_tpu_torch.utils.io.npy import memmap_raw, open_memmap
from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff, write_tiff
from delivr_cfos_tpu_torch.utils.logging import log


def _load_labels_and_stats(cfg: PipelineConfig, brain: str, bin_img: np.ndarray):
    """Reuse the stage-3 label/stats caches when present
    (reference: blob_highlighter.py:25-36,81-94)."""
    post_out = cfg.postprocessing.output_location
    labels = None
    n = None
    stats = None
    if os.path.isdir(post_out):
        for item in os.listdir(post_out):
            if brain in item and item.endswith("-cc3d.npy"):
                try:
                    n = int(item.rsplit("-", 2)[-2])
                except ValueError:
                    continue
                labels = np.load(os.path.join(post_out, item), mmap_mode="r")
            if brain in item and item.endswith(".pickle"):
                with open(os.path.join(post_out, item), "rb") as f:
                    stats = pickle.load(f)
    if labels is None:
        if cfg.FLAGS.LOAD_ALL_RAM:
            native = cc_label_native(np.asarray(bin_img))
            labels, n = native if native is not None else label_volume_host(
                np.asarray(bin_img)
            )
        else:
            # out-of-core relabel into the stage-3 cache location so the next
            # stage-6 run (and a later stage-3 rerun) reuses it
            os.makedirs(post_out, exist_ok=True)
            tmp_path = os.path.join(post_out, f"{brain}-inprogress-cc3d.npy")
            labels_mm = open_memmap(tmp_path, shape=bin_img.shape, dtype=np.int32)
            n, stats = label_out_of_core(bin_img, labels_mm)
            labels_mm.flush()
            del labels_mm
            final = os.path.join(post_out, f"{brain}-{n}-cc3d.npy")
            os.replace(tmp_path, final)
            labels = np.load(final, mmap_mode="r")
    if stats is None:
        if cfg.FLAGS.LOAD_ALL_RAM:
            stats = cc_statistics_native(
                np.asarray(labels), n
            ) or component_statistics(np.asarray(labels), n)
        else:
            stats = component_statistics_streaming(labels, n)
    return labels, n, stats


def _apply_lut_per_plane(labels, lut: np.ndarray, name_fn, device,
                         timer: StepSeconds | None = None) -> None:
    """``lut[labels]`` on ``device`` a z-chunk at a time; each plane's
    deflate-compressed TIFF (three, one per channel, for an RGB table) is
    written by a pool of host threads (zlib releases the GIL), a chunk's
    writes overlapping the next chunk's gather. The reference writes the
    stack serially (blob_highlighter.py:146-171). One worker per core, at
    most 16."""

    def write(z, plane):
        if plane.ndim == 3:  # RGB: three channel files
            for c in range(3):
                write_tiff(name_fn(z, c), plane[..., c], compress=True)
        else:
            write_tiff(name_fn(z, None), plane, compress=True)

    depth = labels.shape[0]
    step = lut_chunk_planes(labels.shape[1:], lut, device)
    pending = []
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as ex:
        for z0 in range(0, depth, step):
            with timed(timer, "lut_gather"):
                chunk = apply_lut(labels[z0 : z0 + step], lut, device)
            with timed(timer, "write"):
                for f in pending:  # the previous chunk's writes, errors raised here
                    f.result()
                pending = [ex.submit(write, z0 + i, chunk[i]) for i in range(len(chunk))]
        with timed(timer, "write"):
            for f in pending:
                f.result()


def _brain_binaries(viz, brain: str, stack_shape: tuple) -> np.ndarray:
    pred_dirs = [d for d in os.listdir(viz.input_prediction_location) if brain in d]
    bin_path = os.path.join(
        viz.input_prediction_location, pred_dirs[0], "binary_segmentations", "binaries.npy"
    )
    return memmap_raw(bin_path, shape=stack_shape[2:], dtype=np.uint8)


def blob_highlighter(cfg: PipelineConfig, brain: str, stack_shape: tuple,
                     device=None) -> dict:
    """Stage 6 for one brain, the lookups on ``device`` (None: the card;
    raises where there is none). Returns the seconds by step."""
    dev = resolve_device(device)
    timer = StepSeconds(dev)
    viz = cfg.visualization
    path_out_rgb = os.path.join(viz.output_location, brain + "_rgb_tiffs")
    path_cache = os.path.join(viz.cache_location, brain)
    os.makedirs(path_out_rgb, exist_ok=True)
    os.makedirs(path_cache, exist_ok=True)

    bin_img = _brain_binaries(viz, brain, stack_shape)
    with timer.step("label_load"):
        labels, n, stats = _load_labels_and_stats(cfg, brain, bin_img)

    if not viz.no_atlas_depthmap:
        csv_candidates = [
            f
            for f in os.listdir(viz.input_csv_location)
            if f"cells_{brain}" in f and f.endswith(".csv")
        ]
        cell_csv = pd.read_csv(
            os.path.join(viz.input_csv_location, csv_candidates[0]), index_col=0
        )
        cell_csv = cell_csv.loc[cell_csv["acronym"] != "bgr"]
        ids = cell_csv["connected_component_id"].to_numpy(int)
        ok = (ids >= 0) & (ids <= n)

        if viz.region_id_rgb:
            log("Coloring blobs (RGB)", brain)
            lut = np.zeros((n + 1, 3), np.uint8)
            lut[ids[ok], 0] = cell_csv["red"].to_numpy(np.uint8)[ok]
            lut[ids[ok], 1] = cell_csv["green"].to_numpy(np.uint8)[ok]
            lut[ids[ok], 2] = cell_csv["blue"].to_numpy(np.uint8)[ok]
            _apply_lut_per_plane(
                labels,
                lut,
                lambda z, c: os.path.join(
                    path_out_rgb, f"{brain}rgb_C{c:02d}_z{str(z).zfill(4)}.tif"
                ),
                dev,
                timer,
            )

        if viz.region_id_grayvalues:
            log("Generating region_id gray-value tiffs", brain)
            path_out_rid = os.path.join(
                viz.output_location, brain, brain + "_region_id_tiffs"
            )
            os.makedirs(path_out_rid, exist_ok=True)
            lut16 = np.zeros((n + 1,), np.uint16)
            lut16[ids[ok]] = cell_csv["graph_order"].to_numpy(np.uint16)[ok]
            _apply_lut_per_plane(
                labels,
                lut16,
                lambda z, _c: os.path.join(
                    path_out_rid, f"region_id_{str(z).zfill(4)}.tif"
                ),
                dev,
                timer,
            )

    if viz.no_atlas_depthmap:
        for step, sec in depth_map_blobs(cfg, brain, stack_shape, labels, n, stats,
                                         device=dev).items():
            timer[step] = timer.get(step, 0.0) + sec

    shutil.rmtree(path_cache, ignore_errors=True)
    return dict(timer)


def depth_map_blobs(
    cfg: PipelineConfig,
    brain: str,
    stack_shape: tuple,
    labels=None,
    n: int | None = None,
    stats: dict | None = None,
    device=None,
) -> dict:
    """Color blobs by their centroid's distance from the sample surface
    (reference: blob_depthmap.py:115-222), the lookup on ``device`` (None:
    the card). Returns the seconds by step."""
    dev = resolve_device(device)
    timer = StepSeconds(dev)
    viz = cfg.visualization
    path_out_dm = os.path.join(viz.output_location, brain, brain + "_depthmap_tiffs")
    os.makedirs(path_out_dm, exist_ok=True)

    bin_img = _brain_binaries(viz, brain, stack_shape)
    if labels is None:
        with timer.step("label_load"):
            labels, n, stats = _load_labels_and_stats(cfg, brain, bin_img)

    ds = cfg.mask_detection.downsample_steps
    with timer.step("distance_transform"):
        masked_stack = read_tiff(
            os.path.join(
                cfg.mask_detection.output_location, brain, "downsampled_masked_stack.tif"
            )
        )
        # anisotropy-aware EDT with a 1-voxel zero pad (blob_depthmap.py:173-183)
        padded = np.pad(masked_stack, 1)
        distances = distance_transform_edt(
            padded,
            sampling=(ds.downsample_um_z, ds.downsample_um_y, ds.downsample_um_x),
        )[1:-1, 1:-1, 1:-1].astype(np.uint16)

    # rescale centroids into downsampled space via µm ratios (:186-191)
    coords = stats["centroids"].copy()
    coords[:, 0] /= ds.downsample_um_z / ds.original_um_z
    coords[:, 1] /= ds.downsample_um_y / ds.original_um_y
    coords[:, 2] /= ds.downsample_um_x / ds.original_um_x
    coords = np.nan_to_num(coords).astype(int)
    coords[:, 0] = np.clip(coords[:, 0], 0, distances.shape[0] - 1)
    coords[:, 1] = np.clip(coords[:, 1], 0, distances.shape[1] - 1)
    coords[:, 2] = np.clip(coords[:, 2], 0, distances.shape[2] - 1)

    # per-label depth LUT; range(N) quirk: labels 0..N−1 colored, blob N not
    # (blob_depthmap.py:196); label 0 (background) never appears in `labels`
    lut = np.zeros((n + 1,), np.uint16)
    upto = min(n, len(coords) - 1)
    depth_vals = distances[coords[: upto + 1, 0], coords[: upto + 1, 1], coords[: upto + 1, 2]]
    lut[: upto + 1] = depth_vals
    if n >= 1:
        lut[n] = 0  # reference's range(N) excludes the last blob
    _apply_lut_per_plane(
        labels,
        lut,
        lambda z, _c: os.path.join(path_out_dm, f"depthmap_{str(z).zfill(4)}.tif"),
        dev,
        timer,
    )
    log("Depth map written", brain)
    return dict(timer)
