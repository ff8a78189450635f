"""Sliding-window inference z-sharded over a device mesh, with halo exchange.

The port's counterpart of ``delivr_cfos_tpu/parallel/sharded_inference.py``
(the reference scatters windows with ``torch.nn.DataParallel``,
inference/inference.py:217-219). The volume is zero-padded in z to
``n_sp·k·stride_z`` planes and cut into equal slabs, one a shard. Each
shard's device holds its slab, pulls an input halo (the planes its last
windows overhang) from the shards to its right, runs every window whose
start lies in its slab through the engine of ``engine/sliding_window.py``
on a replica of the model on its device, and pushes the tail of its
accumulators into the heads of the shards to its right. One process drives
every shard; the halo planes move as device-to-device copies.

The window grid is the single-device engine's (stride
``int(roi·(1−overlap))`` plus one clamped last start) on the original z
extent, dealt to shards by start, so no window lands in the padding and
every window runs once whatever the shard count. Only the summation order
at shard boundaries differs from the single-device run.

TTA noise: each (pass, shard) draws from its own ``torch.Generator``, seeded
from (seed, pass, shard) by ``np.random.SeedSequence``, where the JAX
package folds the shard index into its key; the draws differ from JAX's and
from the single-device engine's.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from delivr_cfos_tpu_torch.engine.sliding_window import (
    SlidingWindowConfig,
    _accumulate,
    _active_mask,
    _dim_starts,
    _divide,
    _grid_starts,
    _importance_for,
    _tta_passes,
    _zero_accumulators,
    auto_batch_size,
    scan_interval,
)
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNet, BasicUNetConfig
from delivr_cfos_tpu_torch.parallel.mesh import Mesh


def plan_sharding(z: int, roi_z: int, stride_z: int, n_sp: int):
    """Host-side plan: padded extent, slab size, halo, and the per-shard
    assignment of the original z starts.

    Returns (z_pad, zloc, halo_in, shard_z_starts) where shard_z_starts[k]
    is the list of slab-local z starts owned by shard k.
    """
    quantum = n_sp * stride_z
    z_pad = -(-z // quantum) * quantum
    zloc = z_pad // n_sp
    zs_global = _dim_starts(z, roi_z, stride_z)
    shard_z_starts = [[] for _ in range(n_sp)]
    halo_in = max(roi_z - stride_z, 0)
    for zg in zs_global:
        k = min(zg // zloc, n_sp - 1)
        local = zg - k * zloc
        overhang = local + roi_z - zloc
        halo_in = max(halo_in, min(overhang, roi_z - 1) if overhang > 0 else 0)
        shard_z_starts[k].append(local)
    # halos wider than a slab come from several shards to the right
    if n_sp > 1 and -(-halo_in // zloc) >= n_sp:
        raise ValueError(
            f"halo {halo_in} needs ≥{-(-halo_in // zloc)} hops on a {n_sp}-way mesh"
        )
    return z_pad, zloc, halo_in, shard_z_starts


def _per_shard_starts(shard_z_starts, ys, xs) -> list:
    """Each shard's (N_k, 3) int32 slab-local window starts, z-major."""
    return [_grid_starts([zs, ys, xs]) for zs in shard_z_starts]


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def replicate(model: BasicUNet, devices) -> dict:
    """{device: the model on it} for each distinct device: the model itself
    on its own device, a copy on every other. A replica runs the same
    forward as the model: on a card, the hand-written kernels."""
    home = _canonical(next(model.parameters()).device)
    out = {home: model}
    for d in map(_canonical, devices):
        if d not in out:
            out[d] = copy.deepcopy(model).to(d)
    return out


def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of ``t`` on ``device``: peer to peer between cards that have
    it, a real copy when both shards share one device too."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t, non_blocking=True)
    return out


def _shard_seed(seed: int, pass_i: int, shard: int) -> int:
    """The noise seed of one (pass, shard), from those numbers alone."""
    state = np.random.SeedSequence([seed, pass_i, shard]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def shard_batch_size(cfg: SlidingWindowConfig, model_cfg: BasicUNetConfig,
                     ext_shape, device) -> int:
    """The window batch of a shard: ``cfg.batch_size``, else sized from
    device memory beside the shard's extended slab (slab + halo) of 2-byte
    input, as the JAX package sizes it."""
    return cfg.batch_size or auto_batch_size(
        tuple(cfg.roi), model_cfg, int(np.prod(ext_shape)) * 2, device=device
    )


def _slab_on(volume, lo: int, hi: int, shape, device):
    """Planes [lo, hi) of the volume on ``device`` in a zeroed buffer of
    ``shape`` (the padding past the volume stays zero). A host uint16 volume
    travels as its int16 bits."""
    src = volume[lo:hi]
    if not isinstance(src, torch.Tensor):
        src = np.require(src, requirements=["C", "W"])  # copies a read-only map
        src = torch.from_numpy(src.view(np.int16) if src.dtype == np.uint16 else src)
    out = torch.zeros(shape, dtype=src.dtype, device=device)
    if hi > lo:
        out[: hi - lo].copy_(src, non_blocking=True)
    return out


@torch.no_grad()
def sharded_accumulate(mesh: Mesh, model: BasicUNet, volume,
                       cfg: SlidingWindowConfig = SlidingWindowConfig(),
                       model_cfg: BasicUNetConfig = BasicUNetConfig(),
                       mesh_axis: str = "sp", seed: int | None = None,
                       win_perm=None, batch: int | None = None,
                       u16: bool | None = None):
    """Every (TTA) pass of a (Z, Y, X) volume, z-sharded over the
    ``mesh_axis`` devices of ``mesh``; returns the raw (acc, cnt) of the
    original extent on the model's device. The building block of
    ``sharded_infer_volume`` and of the streaming engine's mesh slabs.

    ``volume``: a host array, or a device tensor with ``u16`` telling whether
    it holds uint16 bits (the streaming engine's slab). ``seed``: the noise
    seed (default ``cfg.seed``). ``batch``: the window batch of every shard
    (default: ``shard_batch_size`` on each shard's device). The volume must
    be at least roi-sized."""
    devices = [_canonical(d) for d in mesh.axis_devices(mesh_axis)]
    n_sp = len(devices)
    roi = tuple(cfg.roi)
    z, y, x = volume.shape
    if any(volume.shape[i] < roi[i] for i in range(3)):
        raise ValueError(f"volume {tuple(volume.shape)} is smaller than the roi {roi}")
    if u16 is None:
        u16 = not isinstance(volume, torch.Tensor) and volume.dtype == np.uint16
    interval = scan_interval(volume.shape, roi, cfg.overlap)
    _, zloc, halo, shard_z_starts = plan_sharding(z, roi[0], interval[0], n_sp)
    ys = _dim_starts(y, roi[1], interval[1])
    xs = _dim_starts(x, roi[2], interval[2])
    shard_starts = _per_shard_starts(shard_z_starts, ys, xs)
    replicas = replicate(model, devices)
    home = _canonical(next(model.parameters()).device)
    seed = cfg.seed if seed is None else seed
    passes = _tta_passes(cfg)
    imps = {d: _importance_for(cfg, d) for d in replicas}

    # each shard's slab on its device, then its input halo: the next planes
    # to the right, pulled from the shards that hold them (zeros past the end)
    slabs = [_slab_on(volume, k * zloc, min((k + 1) * zloc, z), (zloc, y, x), d)
             for k, d in enumerate(devices)]
    exts = []
    for k, d in enumerate(devices):
        pieces = [slabs[k]]
        for j in range(1, -(-halo // zloc) + 1):
            need = min(zloc, halo - (j - 1) * zloc)
            if k + j < n_sp:
                piece = _copy_to(slabs[k + j][:need], d)
                sharded_accumulate.halo_in_bytes += piece.numel() * piece.element_size()
            else:
                piece = torch.zeros((need, y, x), dtype=slabs[k].dtype, device=d)
            pieces.append(piece)
        exts.append(torch.cat(pieces) if len(pieces) > 1 else slabs[k])
    del slabs

    # every shard's background test before any shard's forwards: each is a
    # host sync, which would otherwise hold back the shards after it
    masks = [_active_mask(ext, u16, s, roi, cfg.background_threshold) if len(s) else None
             for ext, s in zip(exts, shard_starts)]

    accs, cnts = [], []
    for k, (d, ext) in enumerate(zip(devices, exts)):
        acc, cnt = _zero_accumulators(tuple(ext.shape), imps[d], d)
        if len(shard_starts[k]):
            gens = [torch.Generator(device=d).manual_seed(_shard_seed(seed, p, k))
                    for p in range(len(passes))]
            b = batch or shard_batch_size(cfg, model_cfg, ext.shape, d)
            _accumulate(replicas[d], ext, u16, acc, cnt, [shard_z_starts[k], ys, xs],
                        interval, gens, cfg, b, model_cfg, imps[d],
                        active_mask=masks[k], win_perm=win_perm)
        accs.append(acc)
        cnts.append(cnt)
    del exts

    # the tail [zloc, zloc + halo) of each shard spills into the heads of
    # the shards to its right: piece j lands on shard k + j + 1. A shard
    # without windows has a zero tail, and past the last shard lies padding.
    for k in range(n_sp):
        if not len(shard_starts[k]):
            continue
        for j in range(-(-halo // zloc)):
            dst = k + j + 1
            lo, hi = zloc + j * zloc, min(zloc + (j + 1) * zloc, zloc + halo)
            if dst >= n_sp:
                break
            for src, into in ((accs[k], accs[dst]), (cnts[k], cnts[dst])):
                piece = _copy_to(src[lo:hi], devices[dst])
                sharded_accumulate.halo_out_bytes += piece.numel() * piece.element_size()
                into[: hi - lo] += piece
    acc = torch.cat([a[:zloc].to(home) for a in accs])[:z]
    cnt = torch.cat([c[:zloc].to(home) for c in cnts])[:z]
    return acc, cnt


# bytes of halo planes copied between shards: input planes pulled, and
# accumulator planes pushed (f32 sums and the count map)
sharded_accumulate.halo_in_bytes = 0
sharded_accumulate.halo_out_bytes = 0


@torch.no_grad()
def sharded_infer_volume(mesh: Mesh, model: BasicUNet, volume: np.ndarray,
                         cfg: SlidingWindowConfig = SlidingWindowConfig(),
                         model_cfg: BasicUNetConfig = BasicUNetConfig(),
                         mesh_axis: str = "sp", shard_axis: int = 0):
    """Mean logits of a host (Z, Y, X) volume, every (TTA) pass sharded over
    the mesh, on the model's device.

    ``shard_axis`` picks the dimension to distribute (0 = z; 1 = y or 2 = x
    for volumes thin in z): the volume and roi are rotated so that axis
    leads, the z-sharding runs unchanged, windows are rotated back around
    the model, and the result is rotated back. Only the partition differs
    from the single-device engine's."""
    if shard_axis:
        perm = {1: (1, 0, 2), 2: (2, 1, 0)}[shard_axis]  # self-inverse
        roi = tuple(cfg.roi)
        cfg_t = dataclasses.replace(cfg, roi=tuple(roi[a] for a in perm))
        vol_t = np.ascontiguousarray(np.transpose(volume, perm))
        acc, cnt = sharded_accumulate(mesh, model, vol_t, cfg_t, model_cfg,
                                      mesh_axis, win_perm=perm)
        return _divide(acc, cnt).permute(perm).contiguous()
    acc, cnt = sharded_accumulate(mesh, model, volume, cfg, model_cfg, mesh_axis)
    return _divide(acc, cnt)
