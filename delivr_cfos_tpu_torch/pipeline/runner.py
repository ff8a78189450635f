"""Pipeline orchestrator — the stage loop behind ``python -m
delivr_cfos_tpu_torch``.

The counterpart of ``delivr_cfos_tpu/pipeline/runner.py`` (reference:
__main__.py:47-240): creates the folder tree, runs the enabled stages in
order over every brain on one device, emits the HOOK progress lines of the
Fiji plugin, and applies the SAVE_* retention cleanup. Stage-skip checks
match the JAX runner's (which checks ``binaries.npy`` where the reference
checked a file never written there, __main__.py:124), with one repair: a
brain whose stage 2 raised keeps its in-progress marker and runs again
(``stage02_inference.inference_done``), where the JAX runner takes its
zero-filled ``binaries.npy`` as finished.

Not ported yet (ROADMAP.md, "Multi-GPU"): distributing brains over device
groups, ``blob_detection.dcn_slices > 1``, which raises
NotImplementedError; there is no counterpart of ``jax.distributed``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from shutil import rmtree

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.pipeline.common import get_real_size
from delivr_cfos_tpu_torch.utils.device import resolve_device
from delivr_cfos_tpu_torch.utils.hooks import HookEmitter
from delivr_cfos_tpu_torch.utils.logging import StageTimer, log
from delivr_cfos_tpu_torch.utils.profiling import annotate, trace


def run_pipeline(cfg: PipelineConfig, device=None) -> StageTimer:
    """Run all enabled stages on ``device`` (None: the card; raises where
    there is none, before any output is made). Set $DELIVR_TRACE_DIR to
    write a torch.profiler trace of the whole run there."""
    dev = resolve_device(device)
    if cfg.FLAGS.BLOB_DETECTION and cfg.blob_detection.dcn_slices > 1:
        raise NotImplementedError(
            "blob_detection.dcn_slices > 1: distributing brains over device "
            "groups is not ported yet (ROADMAP.md, Modules to port: 'Multi-GPU')"
        )
    with trace():
        return _run_pipeline(cfg, dev)


@contextmanager
def _span(timer: StageTimer, name: str):
    """A StageTimer span that is also a named range in a profiler trace."""
    with timer.span(name), annotate(name):
        yield


def _run_pipeline(cfg: PipelineConfig, device) -> StageTimer:
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
        with _span(timer, "blob_detection"):
            for mouse_i, mouse in enumerate(mice):
                hooks.item(mouse_i, len(mice))
                if inference_done(os.path.join(cfg.blob_detection.output_location, mouse)):
                    log(mouse, "already processed, skipping...")
                    continue
                stack_shape = (1, 1, *get_real_size(os.path.join(cfg.raw_location, mouse)))
                run_inference(cfg, mouse, stack_shape, device=device)

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
