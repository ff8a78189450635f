"""Stage 1 — downsample, mask, and prepare the padded inference volume, on
the card.

The port's counterpart of ``delivr_cfos_tpu/pipeline/stage01_downsample_mask.py``
(reference: downsample/downsample_and_mask.py:139-427), with the same output
contract (directory layout + file names, and the same bytes):

    {mask_output}/{brain}/stack_resampled.tif             16-bit downsampled
    {mask_output}/{brain}/stack_resampled_8bit.tif        contrast-stretched
    {mask_output}/{brain}/stack_resampled_padded_8bit.tif (dims < 250 → 256)
    {mask_output}/{brain}/stack_downsampled.v3draw
    {mask_output}/{brain}/stack_resampled_8bit_mask.tif   mask (Ilastik path)
    {mask_output}/{brain}/mask_us.npy                     mask at raw size
    {mask_output}/{brain}/downsampled_masked_stack.tif (+ _8bit)
    {mask_output}/{brain}/stack_masked_downsampled.v3draw
    {mask_output}/{brain}/masked_tiffs/{plane}.tif
    {mask_output}/{brain}/masked_niftis/masked_nifti.npy  (1,1,Z',Y',X') u16,
        dims padded up to multiples of the inference window

The device work: the block-mean downsample of each z-chunk (uploaded as its
int16 bit pattern), the feature bank and the forest of the mask model, and
the trilinear mask zoom, one z-chunk at a time. The host decodes the TIFF
planes ahead of the device in a bounded pool, keeps the raw-resolution mask
in the ``mask_us.npy`` memmap, and masks the planes into the
``masked_nifti.npy`` memmap in a thread pool.

Reference quirks reproduced for bit-compatibility:

- the z-chunking drops the trailing ``ceil(Z/r)·r − Z … Z`` planes AND the
  final full chunk boundary (``zip(z_series, z_series[1:])`` ⇒ output depth
  is ``ceil(Z/zr) − 1``, downsample_and_mask.py:164,186).
- ``histogram_equalization_8b`` clips its input **in place**, so every
  consumer after the 8-bit conversion (threshold mask, masked downsampled
  stack) sees the percentile-clipped stack (downsample_and_mask.py:118-136).
  The port does this on the host with ``np.percentile``, as the JAX package
  does.
- the "pad if < 250 px" check is a non-empty list (always truthy), so the
  padded 8-bit file is always considered; dims < 250 are zero-padded to 256
  (downsample_and_mask.py:230-240) and the mask is predicted on the padded
  stack.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.models.pixel_classifier import predict_mask_probabilities
from delivr_cfos_tpu_torch.ops.resample import block_mean_downsample, zoom_mask_to
from delivr_cfos_tpu_torch.pipeline.common import get_real_size, list_raw_tiffs
from delivr_cfos_tpu_torch.utils.device import StepSeconds, resolve_device, upload
from delivr_cfos_tpu_torch.utils.io.npy import open_memmap
from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff, write_tiff, write_tiff_stack
from delivr_cfos_tpu_torch.utils.io.v3draw import write_v3draw
from delivr_cfos_tpu_torch.utils.logging import log


def _pad_under_250(stack: np.ndarray) -> np.ndarray:
    """Zero-pad any dim < 250 up to 256 (reference: :230-240)."""
    z, y, x = stack.shape
    out = stack
    if z < 250:
        out = np.pad(out, ((0, 256 - z), (0, 0), (0, 0)), constant_values=0)
    if y < 250:
        out = np.pad(out, ((0, 0), (0, 256 - y), (0, 0)), constant_values=0)
    if x < 250:
        out = np.pad(out, ((0, 0), (0, 0), (0, 256 - x)), constant_values=0)
    return out


def _ingest_workers(threads: int) -> int:
    """0 = auto: one worker per host core, capped (the decode threads share
    the cores with the native strip-decoder's own fan-out)."""
    return threads if threads > 0 else min(16, os.cpu_count() or 1)


def _downsample_stack(raw_tiffs: list, ratios_zyx: tuple, threads: int, device,
                      timer: StepSeconds) -> np.ndarray:
    """Chunked device block-mean downsample, reproducing the reference's
    chunk enumeration (``zip(z_series, z_series[1:])``).

    Host TIFF decode runs ahead of the device work: a bounded pool decodes
    upcoming z-chunks while the device block-means the current one. "decode"
    counts the time spent waiting for a decoded chunk, "downsample" the
    upload, the device work and the copy back."""
    zr, yr, xr = ratios_zyx
    z_series = np.arange(0, len(raw_tiffs), zr)
    bounds = list(zip(z_series, z_series[1:]))

    def decode(b):
        z0, z1 = b
        return np.stack([read_tiff(p) for p in raw_tiffs[z0:z1]], axis=0)

    w = _ingest_workers(threads)
    planes = []
    with ThreadPoolExecutor(max_workers=w) as ex:
        futs = deque()
        idx = 0
        # in-flight decodes bounded at w+1 chunks of host memory
        while idx < min(w + 1, len(bounds)):
            futs.append(ex.submit(decode, bounds[idx]))
            idx += 1
        while futs:
            with timer.step("decode"):
                chunk = futs.popleft().result()
            if idx < len(bounds):
                futs.append(ex.submit(decode, bounds[idx]))
                idx += 1
            with timer.step("downsample"):
                down = block_mean_downsample(upload(chunk, device), (zr, yr, xr))
                planes.append(down.cpu().numpy().astype(np.uint16))
    return np.concatenate(planes, axis=0)


def _equalize_8bit_inplace(stack: np.ndarray) -> np.ndarray:
    """Reference ``histogram_equalization_8b`` including its in-place clip
    side effect on ``stack`` (downsample_and_mask.py:118-136)."""
    minval = round(float(np.percentile(stack.ravel(), 1)))
    maxval = round(float(np.percentile(stack.ravel(), 99)))
    np.clip(stack, minval, maxval, out=stack)
    denom = max(maxval - minval, 1)
    eq16 = (
        (stack.astype(np.float64) - minval) / denom * 65534
    ).astype(np.uint16)
    return (eq16 >> 8).astype(np.uint8)


def downsample_mask(cfg: PipelineConfig, brain: str, device=None) -> dict:
    """Runs stage 1 for ``brain``; ``device`` None means the card. Returns
    the wall seconds by step: "decode", "downsample", "features", "forest",
    "zoom" and "masking" (each device step ends with a synchronize)."""
    device = resolve_device(device)
    timer = StepSeconds(device)
    raw_location = os.path.join(cfg.raw_location, brain)
    raw_tiffs = list_raw_tiffs(raw_location)
    md = cfg.mask_detection
    ratios = md.downsample_steps.ratios_zyx

    results_folder = os.path.join(md.output_location, brain)
    os.makedirs(results_folder, exist_ok=True)

    log("Downsampling", brain, "ratios", ratios)
    downsampled_stack = _downsample_stack(raw_tiffs, ratios, md.ingest_threads,
                                          device, timer)
    write_tiff_stack(
        os.path.join(results_folder, "stack_resampled.tif"),
        downsampled_stack,
        compress=True,
    )
    # NB: clips downsampled_stack in place (reference side effect)
    stack_8bit = _equalize_8bit_inplace(downsampled_stack)
    write_tiff_stack(
        os.path.join(results_folder, "stack_resampled_8bit.tif"),
        stack_8bit,
        compress=True,
    )

    # padded 8-bit + v3draw export (replaces TeraConverter)
    padded_8bit = _pad_under_250(stack_8bit)
    mask_source_name = "stack_resampled_8bit.tif"
    if padded_8bit.shape != stack_8bit.shape:
        mask_source_name = "stack_resampled_padded_8bit.tif"
        write_tiff_stack(
            os.path.join(results_folder, mask_source_name),
            padded_8bit,
            compress=True,
        )
    write_v3draw(
        os.path.join(results_folder, "stack_downsampled.v3draw"), padded_8bit
    )

    raw_shape = get_real_size(raw_location)

    if md.mask_with_Ilastik:
        # learned pixel-classifier mask (replaces the Ilastik subprocess)
        log("Predicting ventricle/background mask", brain)
        probs255 = predict_mask_probabilities(padded_8bit, md.ilastik_model,
                                              device=device, timer=timer)
        write_tiff_stack(
            os.path.join(
                results_folder, mask_source_name.replace(".tif", "") + "_mask.tif"
            ),
            probs255,
            compress=True,
        )
        downsampled_mask = (probs255 >= 125).astype(np.uint8)

        log("Upsampling mask to raw resolution", raw_shape)
        # full-resolution mask lives on disk (reference: mask_us.npy memmap,
        # downsample_and_mask.py:296-299 — a hemisphere mask >> RAM)
        with timer.step("zoom"):
            mask_us = zoom_mask_to(
                downsampled_mask,
                raw_shape,
                out=open_memmap(
                    os.path.join(results_folder, "mask_us.npy"),
                    shape=raw_shape,
                    dtype=np.uint8,
                ),
                device=device,
            )
        # crop the (possibly padded) mask back to the real downsampled grid
        downsampled_mask = downsampled_mask[
            : stack_8bit.shape[0], : stack_8bit.shape[1], : stack_8bit.shape[2]
        ]
    else:
        threshold = int(md.simple_threshold_value)
        downsampled_mask = (downsampled_stack > threshold).astype(np.uint16)
        mask_us = None

    # masked downsampled stack (built from the clipped 16-bit stack)
    masked_ds = (downsampled_mask * downsampled_stack).astype(np.uint16)
    write_tiff_stack(
        os.path.join(results_folder, "downsampled_masked_stack.tif"),
        masked_ds,
        compress=True,
    )
    masked_ds_8bit = _equalize_8bit_inplace(masked_ds)
    write_tiff_stack(
        os.path.join(results_folder, "downsampled_masked_stack_8bit.tif"),
        masked_ds_8bit,
        compress=True,
    )
    write_v3draw(
        os.path.join(results_folder, "stack_masked_downsampled.v3draw"),
        _pad_under_250(masked_ds_8bit),
    )

    # ---- full-resolution masking into the padded inference volume --------
    os.makedirs(os.path.join(results_folder, "masked_tiffs"), exist_ok=True)
    os.makedirs(os.path.join(results_folder, "masked_niftis"), exist_ok=True)

    crop = cfg.blob_detection.window_dimensions.zyx
    padded_shape = tuple(
        int(np.ceil(dim / crop[i]) * crop[i]) for i, dim in enumerate(raw_shape)
    )
    masked_nii = open_memmap(
        os.path.join(results_folder, "masked_niftis", "masked_nifti.npy"),
        shape=(1, 1, *padded_shape),
        dtype=np.uint16,
    )

    threshold = int(md.simple_threshold_value)

    def _mask_plane(args):
        """Per-plane: decode, mask, write memmap row + masked tiff. Planes
        are independent (distinct memmap rows, distinct files); the decode
        (native, GIL-released) and deflate write (zlib, GIL-released) scale
        across host cores (the reference's masking loop is single-threaded,
        downsample_and_mask.py:384-417)."""
        i, path = args
        img = read_tiff(path).astype(np.uint16)
        if md.mask_with_Ilastik:
            img = img * mask_us[i]
        else:
            img[img < threshold] = 0
        masked_nii[0, 0, i, : raw_shape[1], : raw_shape[2]] = img
        write_tiff(
            os.path.join(results_folder, "masked_tiffs", os.path.basename(path)),
            img,
            compress=True,
        )

    with timer.step("masking"):
        with ThreadPoolExecutor(max_workers=_ingest_workers(md.ingest_threads)) as ex:
            # list() drains the iterator so worker exceptions surface here
            list(ex.map(_mask_plane, enumerate(raw_tiffs)))
        masked_nii.flush()
    del masked_nii
    log("Masking done", brain)
    return dict(timer)
