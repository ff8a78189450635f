"""Stage 2 — UNet blob detection over the masked volume, on the card.

The counterpart of ``delivr_cfos_tpu/pipeline/stage02_inference.py``
(reference: inference/inference.py:113-332), with the same output contract:

    {blob_output}/{mouse}/binary_segmentations/binaries.npy   uint8 (Z, Y, X)
    {blob_output}/{mouse}/binary_segmentations/network_output.npy
        float32 sigmoid outputs, only when FLAGS.SAVE_ACTIVATED_OUTPUT

Weights may be the reference torch .tar checkpoint or the JAX package's .npz.
A volume runs in device memory when ``FLAGS.LOAD_ALL_RAM`` is set and it fits
(the reference's switch, inference.py:240-247), else it streams z-slabs
through ``engine/streaming.py`` straight into the disk outputs, resuming from
the sidecar ``streaming_resume.json``. With ``blob_detection.spatial_shards``
above 1, or a caller's mesh of several devices, both branches run z-sharded
over a device mesh (``parallel/sharded_inference.py``), as the JAX package's
do.

A marker file, ``binary_segmentations/inference_in_progress``, exists from
before ``binaries.npy`` is opened until its last write is flushed, so an
inference that raised leaves a brain that ``inference_done`` does not take
as finished (the JAX package's runner skips any ``binaries.npy`` without a
resume sidecar, zeros included).

``run_inference_from_nifti`` runs the same engine on a whole NIfTI volume
(the reference's legacy loader), for weights fresh from training.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.engine.sliding_window import (
    SlidingWindowConfig,
    _device_bytes,
    infer_volume,
)
from delivr_cfos_tpu_torch.engine.streaming import infer_volume_streaming
from delivr_cfos_tpu_torch.models.convert import load_weights
from delivr_cfos_tpu_torch.models.registry import build_model, infer_model_config
from delivr_cfos_tpu_torch.ops.morphology import binarize_logits
from delivr_cfos_tpu_torch.parallel.mesh import make_mesh, visible_devices
from delivr_cfos_tpu_torch.parallel.sharded_inference import (
    require_shardable,
    sharded_infer_volume,
)
from delivr_cfos_tpu_torch.utils.device import resolve_device
from delivr_cfos_tpu_torch.utils.io.nifti import read_nifti
from delivr_cfos_tpu_torch.utils.io.npy import open_memmap
from delivr_cfos_tpu_torch.utils.logging import log
from delivr_cfos_tpu_torch.utils.profiling import annotate

IN_PROGRESS = "inference_in_progress"
RESUME_SIDECAR = "streaming_resume.json"


def inference_done(session_path: str) -> bool:
    """Whether stage 2 finished the brain of ``session_path``
    ({blob_output}/{mouse}): its binaries exist and neither a live resume
    sidecar (a partly streamed run, which run_inference resumes) nor the
    in-progress marker (a run that raised) lies beside them."""
    d = os.path.join(session_path, "binary_segmentations")
    return (os.path.exists(os.path.join(d, "binaries.npy"))
            and not os.path.exists(os.path.join(d, RESUME_SIDECAR))
            and not os.path.exists(os.path.join(d, IN_PROGRESS)))


def resolve_model_config(bd, params, device):
    """The model config for ``blob_detection.precision`` ('fast' | 'parity'
    | 'auto'); 'auto' is 'fast' on CUDA and 'parity' on the CPU. The
    architecture comes from the weights' keys (``models/registry.py``):
    SwinUNETR or BasicUNet. Returns (model_cfg, resolved_mode)."""
    base = infer_model_config(params)
    mode = (bd.precision or "auto").lower()
    if mode == "auto":
        mode = "fast" if torch.device(device).type == "cuda" else "parity"
    if mode not in ("fast", "parity"):
        raise ValueError(
            f"blob_detection.precision must be 'fast', 'parity' or 'auto', "
            f"got {mode!r}"
        )
    return dataclasses.replace(base, precision=mode), mode


def sliding_window_config(cfg: PipelineConfig) -> SlidingWindowConfig:
    """Stage 2's sliding-window settings from the pipeline config."""
    bd = cfg.blob_detection
    return SlidingWindowConfig(
        roi=bd.window_dimensions.zyx,
        overlap=0.5,  # reference: inference.py:125
        tta=cfg.FLAGS.TEST_TIME_AUGMENTATION,
        importance=bd.importance,
        erosion_iters=bd.erosion_iters,
    )


def run_inference(cfg: PipelineConfig, mouse_name: str, stack_shape: tuple,
                  params=None, model_cfg=None,
                  device=None, mesh=None, devices=None) -> str:
    """Returns the session path ({blob_output}/{mouse}). ``params``: a
    MONAI-keyed state dict (``models/convert.py::load_weights``); ``device``:
    None means CUDA.

    Spatial sharding, as the JAX package decides it: a caller's ``mesh``
    (``parallel/mesh.py``; the runner's slice of a ``dcn_slices`` run) of
    several devices shards over them, one of a single device runs on that
    device unsharded; else ``blob_detection.spatial_shards`` above 1 shards
    over that many of ``devices`` (default: every visible CUDA device, or
    ``[device]`` off CUDA) where there are as many, and runs on ``device``
    with a warning where there are not. With a mesh, the model and the
    outputs live on its first device."""
    with annotate("stream.run_inference"):
        return _run_inference(cfg, mouse_name, stack_shape, params, model_cfg, device,
                              mesh, devices)


def _run_inference(cfg, mouse_name, stack_shape, params, model_cfg, device, mesh,
                   devices) -> str:
    device = resolve_device(device)
    bd = cfg.blob_detection
    if mesh is not None:
        device = resolve_device(mesh.devices.flat[0])
        if mesh.devices.size > 1:
            log(f"Spatial sharding over caller mesh ({mesh.devices.size} chips)")
        else:
            mesh = None
    elif bd.spatial_shards > 1:
        devices = visible_devices(device) if devices is None else list(devices)
        if len(devices) >= bd.spatial_shards:
            mesh = make_mesh({"sp": bd.spatial_shards}, devices=devices)
            device = resolve_device(mesh.devices.flat[0])
            log(f"Spatial sharding over {bd.spatial_shards} chips")
        else:
            log(
                f"WARNING: spatial_shards={bd.spatial_shards} but only "
                f"{len(devices)} devices — running single-chip"
            )
    input_path = os.path.join(
        bd.input_location, mouse_name, "masked_niftis", "masked_nifti.npy"
    )
    session_path = os.path.join(bd.output_location, mouse_name)
    binaries_path = os.path.join(session_path, "binary_segmentations")

    volume = np.load(input_path, mmap_mode="r")[0, 0]
    real_z, real_y, real_x = stack_shape[2:]
    real = (real_z, real_y, real_x)
    # input + f32 accumulator + i32 count ≈ 10 bytes/voxel must fit in 0.75
    # of device memory beside the window batch; otherwise, or without
    # LOAD_ALL_RAM, z-slabs stream (reference: inference.py:240-247)
    device_bytes = int(_device_bytes(device)[0] * 0.75)
    whole_volume_ok = cfg.FLAGS.LOAD_ALL_RAM and volume.size * 10 < device_bytes
    os.makedirs(binaries_path, exist_ok=True)

    with annotate("stream.build_model"):
        if params is None:
            log("Loading weights", bd.model_location)
            params = load_weights(bd.model_location)
        if model_cfg is None:
            model_cfg, mode = resolve_model_config(bd, params, device)
            log(f"Model precision mode: {mode} on {device}")
        if mesh is not None:
            require_shardable(model_cfg)
        model = build_model(params, model_cfg, device)

    sw_cfg = sliding_window_config(cfg)
    log(
        f"Inference for {mouse_name}: padded {volume.shape}, "
        f"real {real}, tta={sw_cfg.tta}, device={device}, "
        f"mode={'in device memory' if whole_volume_ok else 'streaming'}"
    )
    resume_path = os.path.join(binaries_path, RESUME_SIDECAR)
    binaries_file = os.path.join(binaries_path, "binaries.npy")
    activated_file = os.path.join(binaries_path, "network_output.npy")
    # a live sidecar means a partly streamed binaries.npy is on disk: reopen
    # it in place so that the finished chunks survive the resume
    resuming = (not whole_volume_ok and os.path.exists(resume_path)
                and _is_npy(binaries_file, real, np.uint8))
    marker = os.path.join(binaries_path, IN_PROGRESS)
    open(marker, "w").close()
    out = open_memmap(binaries_file, shape=real, dtype=np.uint8,
                      mode="r+" if resuming else "w+")
    activated = None
    if cfg.FLAGS.SAVE_ACTIVATED_OUTPUT:
        os.makedirs(os.path.join(session_path, "network_outputs"), exist_ok=True)
        keep = resuming and _is_npy(activated_file, real, np.float32)
        activated = open_memmap(activated_file, shape=real, dtype=np.float32,
                                mode="r+" if keep else "w+")
        if resuming and not keep:
            os.remove(resume_path)  # no sigmoid output to resume into

    if whole_volume_ok:
        if mesh is not None:
            mean_logits = sharded_infer_volume(
                mesh, model, np.asarray(volume), sw_cfg, model_cfg
            )
        else:
            mean_logits, _ = infer_volume(
                model, np.asarray(volume), sw_cfg, model_cfg, return_binary=False
            )
        logits_real = mean_logits[:real_z, :real_y, :real_x]
        # binarization over the REAL (unpadded) extent, reference create_nifti_seg
        input_real = torch.from_numpy(
            np.asarray(volume[:real_z, :real_y, :real_x]) > 0
        ).to(device)
        out[:] = binarize_logits(
            logits_real, input_real, threshold=sw_cfg.threshold,
            erosion_iters=sw_cfg.erosion_iters,
        ).cpu().numpy()
        if activated is not None:
            activated[:] = torch.sigmoid(logits_real).cpu().numpy()
        # a brain interrupted mid-stream and completed here would otherwise
        # keep its sidecar, and the runner's skip check (binaries exist AND
        # no sidecar) would re-run it every launch
        if os.path.exists(resume_path):
            os.remove(resume_path)
    else:
        # out-of-core: finalized chunks go straight into the disk memmaps;
        # no full-volume host buffer is made
        infer_volume_streaming(
            model, volume, sw_cfg, model_cfg, binary_out=out,
            sigmoid_out=activated, out_shape=real,
            resume_state_path=resume_path, mesh=mesh,
        )
    if activated is not None:
        activated.flush()
        del activated
    out.flush()
    del out
    os.remove(marker)
    log("Blob detection finished", mouse_name)
    return session_path


def _is_npy(path: str, shape, dtype) -> bool:
    """Whether ``path`` is a .npy of this shape and dtype (an output that a
    resume may reopen in place)."""
    if not os.path.exists(path):
        return False
    try:
        mm = np.load(path, mmap_mode="r")
    except (OSError, ValueError):
        return False
    return mm.shape == tuple(shape) and mm.dtype == np.dtype(dtype)


def run_inference_from_nifti(nifti_path: str, weights_path: str,
                             output_binaries_path: str, tta: bool = False,
                             window: tuple = (96, 96, 64), threshold: float = 0.5,
                             device=None) -> np.ndarray:
    """The JAX package's variant of the reference's legacy NIfTI loader
    (reference: inference/inference_nifti_load.py — a whole .nii in RAM
    instead of the memmapped npy): read a NIfTI volume (reference axis
    convention, (y, x, z) → (z, y, x)), run sliding-window inference on
    ``device`` (None means the card; raises without CUDA), write the
    binaries as a .npy memmap. The forward is the fast one, on the
    hand-written kernels, on CUDA and parity on the CPU (where the JAX
    package always runs parity), as ``blob_detection.precision`` 'auto'
    resolves. Returns the binary volume."""
    device = resolve_device(device)
    params = load_weights(weights_path)
    mode = "fast" if device.type == "cuda" else "parity"
    model_cfg = dataclasses.replace(infer_model_config(params), precision=mode)
    vol = np.ascontiguousarray(
        np.transpose(np.asarray(read_nifti(nifti_path)), (2, 0, 1))
    ).astype(np.uint16)
    sw_cfg = SlidingWindowConfig(roi=window, tta=tta, threshold=threshold)
    _, binaries = infer_volume(build_model(params, model_cfg, device), vol, sw_cfg, model_cfg)
    binaries = binaries.cpu().numpy()
    if output_binaries_path:
        mm = open_memmap(output_binaries_path, shape=binaries.shape, dtype=np.uint8)
        mm[:] = binaries
        mm.flush()
    return binaries
