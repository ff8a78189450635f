"""Stage 3 — connected-component blob extraction → per-cell CSV.

The counterpart of ``delivr_cfos_tpu/pipeline/stage03_count_blobs.py``
(reference: count_blobs.py:36-118), on the host: the native C++ union-find
when it builds, else scipy (``ops/connected_components.py``,
``native/cc.py``). Same output contract, byte for byte:

    {post_output}/{brain}-{N}-cc3d.npy      cached labels
    {post_output}/{brain}-stats.pickle      cached statistics dict
    {post_output}(Z, Y, X)_{brain}.csv      per-blob table (path joined as
                                            strings, as the reference does)

The CSV is written with the standard library's ``csv`` module, not pandas
(the GPU machine has none), in the bytes pandas' ``DataFrame.to_csv`` gives
the JAX package's table:
- header ``,Blob,Coords,Size``; the index column is 0 on every row (the
  reference row-appends single-row frames, count_blobs.py:104-110);
- ``Coords`` is ``str()`` of the centroid's [z, y, x] list of Python floats,
  quoted because it holds commas; lines end in ``\\n``;
- the loop runs ``range(1, N)`` — the last component N is dropped
  (reference bug, count_blobs.py:104); kept for table parity.
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.native.cc import cc_label_native, cc_statistics_native
from delivr_cfos_tpu_torch.ops.connected_components import (
    component_statistics,
    component_statistics_streaming,
    label_out_of_core,
    label_volume_host,
)
from delivr_cfos_tpu_torch.utils.io.npy import memmap_raw, open_memmap
from delivr_cfos_tpu_torch.utils.logging import log


def _load_cached_labels(path_out: str, brain: str):
    for item in (x for x in os.listdir(path_out) if x.endswith(".npy")):
        if brain in item and "-cc3d" in item:
            try:
                n = int(item.rsplit("-", 2)[-2])
            except ValueError:
                continue
            # memmapped: stage 3 only needs the stats; stage 6 streams planes
            return np.load(os.path.join(path_out, item), mmap_mode="r"), n
    return None


def _load_cached_stats(path_out: str, brain: str):
    for item in (x for x in os.listdir(path_out) if x.endswith(".pickle")):
        if brain in item:
            with open(os.path.join(path_out, item), "rb") as f:
                return pickle.load(f)
    return None


def write_blob_csv(out_path: str, stats: dict, n: int) -> None:
    """The per-blob table of components 1..n−1, in pandas' ``to_csv`` bytes."""
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", "Blob", "Coords", "Size"])
        for i in range(1, n):
            # .tolist() → plain Python floats, so str(list) reprs match
            coords = np.asarray(stats["centroids"][i]).tolist()
            w.writerow([0, i, str(coords), int(stats["voxel_counts"][i])])


def count_blobs(
    cfg: PipelineConfig,
    path_in: str,
    brain_i: int,
    brain: str,
    stack_shape: tuple,
    min_size: int = -1,
    max_size: int = -1,
) -> str:
    path_out = cfg.postprocessing.output_location
    os.makedirs(path_out, exist_ok=True)

    brain_path = os.path.join(path_in, brain, "binary_segmentations", "binaries.npy")
    bin_img = memmap_raw(brain_path, shape=stack_shape[2:], dtype=np.uint8)

    load_all_ram = cfg.FLAGS.LOAD_ALL_RAM
    stats = None
    cached = _load_cached_labels(path_out, brain)
    if cached is None:
        log("Labeling connected components", brain)
        cc_workers = cfg.postprocessing.cc_workers
        if load_all_ram and cc_workers <= 1:
            # in-RAM path (reference default: cc3d without out_file,
            # count_blobs.py:59-62)
            vol = np.asarray(bin_img)
            native = cc_label_native(vol)
            if native is not None:
                labels, n = native
            else:
                labels, n = label_volume_host(vol)
            np.save(os.path.join(path_out, f"{brain}-{n}-cc3d.npy"), labels)
        elif load_all_ram:
            # in-RAM + cc_workers>1: slab-parallel labeling into an in-RAM
            # label array — bit-identical to the whole-volume engines
            # (canonical first-raster order), with the per-slab native sweeps
            # fanned out across host cores
            vol = np.asarray(bin_img)
            labels = np.empty(vol.shape, np.int32)
            n, stats = label_out_of_core(vol, labels, workers=cc_workers)
            np.save(os.path.join(path_out, f"{brain}-{n}-cc3d.npy"), labels)
        else:
            # out-of-core path (reference: cc3d out_file= disk labeling for
            # RAM < 2× dataset, count_blobs.py:63-64): slab-streamed labeling
            # straight into the cache memmap; N is only known at the end, so
            # label into a temp name and rename into the cache contract
            tmp_path = os.path.join(path_out, f"{brain}-inprogress-cc3d.npy")
            labels_mm = open_memmap(tmp_path, shape=bin_img.shape, dtype=np.int32)
            n, stats = label_out_of_core(bin_img, labels_mm, workers=cc_workers)
            labels_mm.flush()
            del labels_mm
            final_path = os.path.join(path_out, f"{brain}-{n}-cc3d.npy")
            os.replace(tmp_path, final_path)
            labels = np.load(final_path, mmap_mode="r")
    else:
        labels, n = cached
        log("Cached labels found", brain, n)

    if stats is None:
        stats = _load_cached_stats(path_out, brain)
    if stats is None:
        if load_all_ram:
            lab_arr = np.asarray(labels)
            stats = cc_statistics_native(lab_arr, n) or component_statistics(
                lab_arr, n
            )
        else:
            stats = component_statistics_streaming(labels, n)
    stats_path = os.path.join(path_out, f"{brain}-stats.pickle")
    if not os.path.exists(stats_path):
        with open(stats_path, "wb") as f:
            pickle.dump(stats, f, protocol=pickle.HIGHEST_PROTOCOL)

    output_name = f"{tuple(bin_img.shape)}_{brain.replace('.nii.gz', '')}.csv"
    out_path = path_out + output_name
    write_blob_csv(out_path, stats, n)
    log("Blob counting done", brain, f"{max(n - 1, 0)} blobs written")
    return out_path
