"""Pipeline orchestrator — the stage loop behind ``python -m
delivr_cfos_tpu_torch``.

The counterpart of ``delivr_cfos_tpu/pipeline/runner.py`` (reference:
__main__.py:47-240): creates the folder tree, runs the enabled stages in
order over every brain, emits the HOOK progress lines of the Fiji plugin,
and applies the SAVE_* retention cleanup. Stage-skip checks
match the JAX runner's (which checks ``binaries.npy`` where the reference
checked a file never written there, __main__.py:124), with one repair: a
brain whose stage 2 raised keeps its in-progress marker and runs again
(``stage02_inference.inference_done``), where the JAX runner takes its
zero-filled ``binaries.npy`` as finished.

Several devices and processes, as the JAX runner has them: a multi-process
launch (``DELIVR_COORDINATOR`` / ``DELIVR_NUM_PROCESSES`` /
``DELIVR_PROCESS_ID``, or torchrun's variables) joins a ``torch.distributed``
group before any device is queried, and ``blob_detection.dcn_slices`` above
1 deals the brains round-robin over that many slices of the devices, each
brain's spatial sharding inside its slice; with several processes each
serves the slice of its rank.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from shutil import rmtree

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.parallel.mesh import (
    assign_brains_to_slices,
    make_hybrid_mesh,
    maybe_initialize_distributed,
    process_index,
    slice_submeshes,
    visible_devices,
)
from delivr_cfos_tpu_torch.pipeline.common import get_real_size
from delivr_cfos_tpu_torch.utils.device import resolve_device
from delivr_cfos_tpu_torch.utils.hooks import HookEmitter
from delivr_cfos_tpu_torch.utils.logging import StageTimer, log
from delivr_cfos_tpu_torch.utils.profiling import annotate, trace


def run_pipeline(cfg: PipelineConfig, device=None, devices=None) -> StageTimer:
    """Run all enabled stages on ``device`` (None: the card; raises where
    there is none, before any output is made). ``devices``: the devices
    stage 2 may spread over (``spatial_shards``, ``dcn_slices``); default
    every visible CUDA device, or ``[device]`` off CUDA. Set
    $DELIVR_TRACE_DIR to write a torch.profiler trace of the whole run
    there."""
    # a multi-process launch joins its group before any device query, so
    # that the rank drives the per-slice brain filter
    joined = maybe_initialize_distributed()
    dev = resolve_device(device)
    if joined:
        rank, world = process_index()
        log(f"torch.distributed initialized: process {rank}/{world}, "
            f"{len(visible_devices(dev))} local devices")
    devices = visible_devices(dev) if devices is None else [resolve_device(d) for d in devices]
    with trace():
        return _run_pipeline(cfg, dev, devices)


@contextmanager
def _span(timer: StageTimer, name: str):
    """A StageTimer span that is also a named range in a profiler trace."""
    with timer.span(name), annotate(name):
        yield


def _brain_meshes(n_slices: int, n_brains: int, devices) -> dict:
    """{brain index: (slice, submesh)} of the brains this process serves, as
    the JAX runner deals them: round-robin over ``n_slices`` slices of the
    devices; with several processes each serves the slice of its rank, the
    devices of every process standing in for the global list (each process
    drives its own). Empty, with a warning, where there are fewer devices
    than slices."""
    rank, world = process_index()
    n_global = len(devices) * world
    if n_global < n_slices:
        log(f"WARNING: dcn_slices={n_slices} but only {n_global} devices — "
            "running undistributed")
        return {}
    subs = slice_submeshes(make_hybrid_mesh(n_slices=n_slices, devices=devices * world))
    per_slice = assign_brains_to_slices(n_brains, len(subs))
    mine = [rank % len(subs)] if world > 1 else range(len(subs))
    log(f"Distributing {n_brains} brains over {len(subs)} DCN slices "
        f"({subs[0].devices.size} chips each)")
    return {bi: (s, subs[s]) for s in mine for bi in per_slice[s]}


def _run_pipeline(cfg: PipelineConfig, device, devices) -> StageTimer:
    from delivr_cfos_tpu_torch.pipeline.stage02_inference import inference_done

    cfg.setup_folders()
    flags = cfg.FLAGS
    n_stages = sum(
        [
            flags.MASK_DOWNSAMPLE,
            flags.BLOB_DETECTION,
            flags.POSTPROCESSING,
            flags.ATLAS_ALIGNMENT,
            flags.REGION_ASSIGNMENT,
            flags.VISUALIZATION,
        ]
    )
    hooks = HookEmitter(n_stages)
    hooks.overall()
    timer = StageTimer()

    if flags.MASK_DOWNSAMPLE:
        from delivr_cfos_tpu_torch.pipeline.stage01_downsample_mask import downsample_mask

        log("Masking")
        hooks.begin_stage()
        brain_list = sorted(os.listdir(cfg.raw_location))
        with _span(timer, "mask_downsample"):
            for brain_i, brain in enumerate(brain_list):
                hooks.item(brain_i, len(brain_list))
                done = os.path.join(
                    cfg.mask_detection.output_location, brain, "masked_niftis"
                )
                if os.path.exists(done):
                    log(brain, "exists, skipping...")
                    continue
                downsample_mask(cfg, brain, device=device)

    if flags.BLOB_DETECTION:
        from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference

        log("Blob detection")
        hooks.begin_stage()
        batch = cfg.blob_detection.input_location or cfg.mask_detection.output_location
        mice = sorted(
            d for d in os.listdir(batch) if os.path.isdir(os.path.join(batch, d))
        )
        # brains are independent: with dcn_slices > 1 the brain loop maps
        # over slices of the devices, each brain's halo exchange inside one
        brain_mesh = {}
        if cfg.blob_detection.dcn_slices > 1:
            brain_mesh = _brain_meshes(cfg.blob_detection.dcn_slices, len(mice), devices)
        with _span(timer, "blob_detection"):
            for mouse_i, mouse in enumerate(mice):
                hooks.item(mouse_i, len(mice))
                if brain_mesh and mouse_i not in brain_mesh:
                    log(mouse, "assigned to another slice/host, skipping...")
                    continue
                if inference_done(os.path.join(cfg.blob_detection.output_location, mouse)):
                    log(mouse, "already processed, skipping...")
                    continue
                stack_shape = (1, 1, *get_real_size(os.path.join(cfg.raw_location, mouse)))
                if brain_mesh:
                    s, sub = brain_mesh[mouse_i]
                    log(f"{mouse} → DCN slice {s}")
                    run_inference(cfg, mouse, stack_shape, device=device, mesh=sub)
                else:
                    run_inference(cfg, mouse, stack_shape, device=device, devices=devices)

    if flags.POSTPROCESSING:
        from delivr_cfos_tpu_torch.pipeline.stage03_count_blobs import count_blobs

        log("Postprocessing")
        hooks.begin_stage()
        path_in = cfg.postprocessing.input_location
        brains = sorted(os.listdir(path_in))
        with _span(timer, "postprocessing"):
            for brain_i, brain in enumerate(brains):
                hooks.item(brain_i, len(brains))
                stack_shape = (1, 1, *get_real_size(os.path.join(cfg.raw_location, brain)))
                count_blobs(
                    cfg,
                    path_in,
                    brain_i,
                    brain,
                    stack_shape,
                    cfg.postprocessing.min_size,
                    cfg.postprocessing.max_size,
                )

    if flags.ATLAS_ALIGNMENT:
        from delivr_cfos_tpu_torch.pipeline.stage04_atlas_align import (
            run_registration_and_point_warp,
        )

        log("Atlas alignment")
        hooks.begin_stage()
        csvs = sorted(
            os.path.join(cfg.postprocessing.output_location, f)
            for f in os.listdir(cfg.postprocessing.output_location)
            if f.endswith(".csv")
        )
        with _span(timer, "atlas_alignment"):
            for brain_i, blob_csv in enumerate(csvs):
                hooks.item(brain_i, len(csvs))
                try:
                    run_registration_and_point_warp(cfg, blob_csv, device=device)
                except Exception as e:  # per-brain resilience (__main__.py:177-188)
                    log(f"Error encountered, skipping {blob_csv}: {e}")

    if flags.REGION_ASSIGNMENT:
        from delivr_cfos_tpu_torch.pipeline.stage05_region_assignment import (
            map_cells_to_atlas,
        )

        log("Region assignment")
        hooks.begin_stage()
        with _span(timer, "region_assignment"):
            map_cells_to_atlas(cfg, hooks, device=device)

    if flags.VISUALIZATION:
        from delivr_cfos_tpu_torch.pipeline.stage06_visualization import blob_highlighter

        log("Visualization")
        hooks.begin_stage()
        mice = sorted(os.listdir(cfg.visualization.input_prediction_location))
        with _span(timer, "visualization"):
            for brain_i, mouse in enumerate(mice):
                hooks.item(brain_i, len(mice))
                stack_shape = (1, 1, *get_real_size(os.path.join(cfg.raw_location, mouse)))
                blob_highlighter(cfg, mouse, stack_shape, device=device)

    # cleanup (reference: __main__.py:224-239)
    if flags.MASK_DOWNSAMPLE and not flags.SAVE_MASK_OUTPUT:
        log("Removing masking output...")
        rmtree(cfg.mask_detection.output_location)
    if flags.BLOB_DETECTION and not flags.SAVE_NETWORK_OUTPUT:
        log("Removing network output...")
        rmtree(cfg.blob_detection.output_location)
    if flags.POSTPROCESSING and not flags.SAVE_POSTPROCESSING_OUTPUT:
        log("Removing postprocessing output...")
        rmtree(cfg.postprocessing.output_location)
    if flags.ATLAS_ALIGNMENT and not flags.SAVE_ATLAS_OUTPUT:
        log("Removing atlas alignment output...")
        rmtree(cfg.atlas_alignment.output_location)
    log("DELIVR Done.")
    return timer
