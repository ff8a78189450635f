"""Out-of-core streaming inference: host → device z-slab pipeline.

The counterpart of ``delivr_cfos_tpu/engine/streaming.py``. The reference
keeps terabyte volumes on disk and accumulates into memmapped float16
buffers with per-batch host↔device round trips (reference:
inference/inference.py:229-265). Here a contiguous run of window-grid z-rows
(a slab) is uploaded, every (TTA) pass accumulates on the device, the
overlap tail that the next slab also touches is carried forward on the
device, and only finalized mean-logit / sigmoid / binary chunks return to the
host. Peak device memory is one slab (input + f32 accumulator + count, and
the next slab's input while it uploads), whatever the volume's size.

Each slab runs the engine of ``engine/sliding_window.py`` on its local grid,
or, with ``mesh=``, z-sharded over the mesh's devices
(``parallel/sharded_inference.py``); its TTA noise comes from a
``torch.Generator`` seeded from (seed, slab index), and on a mesh from
(that seed, pass, shard), so a resumed run draws the noise an uninterrupted
run drew.
Binarization crops to ``out_shape`` and erodes each chunk with
``erosion_iters`` planes of z-context, so chunk cuts erode exactly as the
whole volume does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import torch

from delivr_cfos_tpu_torch.engine.sliding_window import (
    SlidingWindowConfig,
    _accumulate,
    _dim_starts,
    _divide,
    _importance_for,
    _nonzero,
    _zero_accumulators,
    auto_batch_size,
    scan_interval,
    windows_that_fit,
)
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNet, BasicUNetConfig
from delivr_cfos_tpu_torch.ops.morphology import binary_erosion_cross
from delivr_cfos_tpu_torch.parallel.sharded_inference import (
    require_shardable,
    sharded_accumulate,
)
from delivr_cfos_tpu_torch.utils.profiling import annotate

ENGINE = "delivr_cfos_tpu_torch"  # sidecars of other engines never match
SLAB_Z_STARTS = 4  # window grid rows per slab, at most


def _slab_depth_planes(volume_shape, roi, interval, slab_z_starts: int) -> int:
    n_z = len(_dim_starts(volume_shape[0], roi[0], interval[0]))
    return (min(slab_z_starts, n_z) - 1) * interval[0] + roi[0]


def slab_depth(cfg: SlidingWindowConfig, model_cfg: BasicUNetConfig, volume_shape,
               itemsize: int, device) -> int:
    """Window rows per slab: ``SLAB_Z_STARTS``, or fewer, down to 1, where a
    slab of that many rows at the volume's full y·x leaves no room for one
    window in the device memory that ``auto_batch_size`` budgets (a real
    brain's y·x on a card of less memory)."""
    roi = tuple(cfg.roi)
    interval = scan_interval(volume_shape, roi, cfg.overlap)
    plane = volume_shape[1] * volume_shape[2] * itemsize
    for k in range(SLAB_Z_STARTS, 1, -1):
        depth = _slab_depth_planes(volume_shape, roi, interval, k)
        if windows_that_fit(roi, model_cfg, depth * plane, device=device) >= 1:
            return k
    return 1


def slab_batch_size(cfg: SlidingWindowConfig, model_cfg: BasicUNetConfig,
                    volume_shape, itemsize: int, slab_z_starts: int,
                    device) -> int:
    """The window batch of a streamed run: ``cfg.batch_size``, else sized
    from one slab's bytes, not the volume's."""
    roi = tuple(cfg.roi)
    interval = scan_interval(volume_shape, roi, cfg.overlap)
    depth = _slab_depth_planes(volume_shape, roi, interval, slab_z_starts)
    return cfg.batch_size or auto_batch_size(
        roi, model_cfg, depth * volume_shape[1] * volume_shape[2] * itemsize,
        device=device,
    )


def resume_signature(cfg: SlidingWindowConfig, volume_shape, out_shape,
                     slab_z_starts: int, batch: int, spatial_shards: int = 1) -> dict:
    """The resume sidecar's signature: every ``SlidingWindowConfig`` field,
    the resolved window batch (the noise a chunk draws depends on how the
    windows are batched), the slab depth and the shapes, the shard count of
    a mesh run (its noise and summation order differ from one device's),
    and the engine. A sidecar of the JAX package never matches: its noise
    and summation order differ."""
    sig = {
        "engine": ENGINE,
        **dataclasses.asdict(cfg),
        "batch": batch,
        "slab_z_starts": slab_z_starts,
        "spatial_shards": spatial_shards,
        "shape": list(volume_shape),
        "out_shape": list(out_shape),
    }
    return json.loads(json.dumps(sig))  # the form a JSON round trip gives


def _slab_seed(seed: int, slab_i: int) -> int:
    """The noise seed of one slab, from (seed, slab index) alone."""
    state = np.random.SeedSequence([seed, slab_i]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


class _OrderedWorker:
    """Runs thunks one at a time, in order, on daemon threads (inline when
    not ``threaded``). ``submit`` and ``wait`` first join the previous thunk
    and re-raise its error on the caller's thread: at most one is
    outstanding."""

    def __init__(self, threaded: bool):
        self._threaded = threaded
        self._thread = None
        self._err = None

    def submit(self, fn) -> None:
        self.wait()
        if not self._threaded:
            fn()
            return

        def run():
            try:
                fn()
            except BaseException as e:  # re-raised on the caller's thread
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        """Join the outstanding thunk without raising: for a caller that
        is already unwinding an error of its own."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class _SlabLoader:
    """Slices slabs of the host volume (a disk memmap, typically) and puts
    them on the device, one slab ahead on a worker thread with ``prefetch``.
    On CUDA the slice goes into a pinned host buffer and uploads on a copy
    stream of its own; ``take`` makes the caller's stream wait for it.
    uint16 travels as its int16 bits, as ``_upload_volume`` does."""

    def __init__(self, volume, device, prefetch: bool):
        self._volume = volume
        self._device = device
        self.worker = _OrderedWorker(prefetch)
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._bounds = None
        self._out = None

    def _load(self, z0: int, z1: int) -> None:
        src = self._volume[z0:z1]
        u16 = src.dtype == np.uint16
        if u16:
            src = src.view(np.int16)
        if self._stream is None:
            self._out = (torch.from_numpy(np.array(src)), u16, None)
            return
        dtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
        host = torch.empty(src.shape, dtype=dtype, pin_memory=True)
        host.numpy()[...] = src
        with torch.cuda.stream(self._stream):
            dev = host.to(self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self._out = (dev, u16, ready)

    def start(self, z0: int, z1: int) -> None:
        self._bounds = (z0, z1)
        self.worker.submit(lambda: self._load(z0, z1))

    def take(self, z0: int, z1: int):
        """(slab [z0, z1) on the device, whether it holds uint16 bits)."""
        with annotate("stream.slab_wait"):
            if self._bounds != (z0, z1):
                self.start(z0, z1)
            self.worker.wait()
        dev, u16, ready = self._out
        self._out = self._bounds = None
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            dev.record_stream(stream)  # allocated on the copy stream
        return dev, u16


class _ChunkWriter:
    """Copies finalized device chunks to the host and writes them into the
    outputs, in order, on a worker thread with ``threaded``; then advances
    the resume sidecar. On CUDA the copies run on a stream of their own
    after an event of the compute stream, so they overlap the next slab."""

    def __init__(self, device, threaded: bool, resume_state_path, sig):
        self.worker = _OrderedWorker(threaded)
        self._device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._path = resume_state_path
        self._sig = sig

    def submit(self, pairs, lo: int, hi: int, next_slab: int, finalized: int):
        """``pairs``: (host array, device chunk for its planes [lo, hi))."""
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))

        def job():
            if ready is not None:
                with torch.cuda.stream(self._stream):
                    self._stream.wait_event(ready)
                    host = [t.cpu() for _, t in pairs]
            else:
                host = [t for _, t in pairs]
            for (dst, _), h in zip(pairs, host):
                dst[lo:hi] = h.numpy()
                if isinstance(dst, np.memmap):
                    dst.flush()
            if self._path:
                # the sidecar advances only after its chunk's bytes are
                # written; replaced atomically, so a crash leaves the old one
                tmp = f"{self._path}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"sig": self._sig, "next_slab": next_slab,
                               "finalized": finalized}, f)
                os.replace(tmp, self._path)

        self.wait()  # the previous chunk's copies and writes
        self.worker.submit(job)

    def wait(self) -> None:
        with annotate("stream.writer_wait"):
            self.worker.wait()


def _resume_point(path, sig, z_starts, slab_z_starts, n_slabs, roi_z):
    """(start_slab, regen_before_slab, finalized) from a sidecar whose
    signature matches, else (0, 0, 0): a restart from scratch.

    Slabs below ``regen_before_slab`` are already on disk and run again only
    to rebuild the overlap carry: every slab with a window that still reaches
    at or above ``finalized``. The clamped last start can put slab bounds
    close together, so the depth comes from the grid, not from a rule."""
    if not path or not os.path.exists(path):
        return 0, 0, 0
    try:
        with open(path) as f:
            state = json.load(f)
        next_slab, finalized = int(state["next_slab"]), int(state["finalized"])
        ok = (state.get("sig") == sig and 0 < next_slab < n_slabs
              and finalized == z_starts[next_slab * slab_z_starts])
    except (OSError, ValueError, KeyError, TypeError):
        return 0, 0, 0
    if not ok:
        return 0, 0, 0
    k = int(np.searchsorted(z_starts, finalized - roi_z, side="right"))
    return min(k // slab_z_starts, next_slab - 1), next_slab, finalized


@torch.no_grad()
def infer_volume_streaming(model: BasicUNet, volume,
                           cfg: SlidingWindowConfig = SlidingWindowConfig(),
                           model_cfg: BasicUNetConfig = BasicUNetConfig(),
                           slab_z_starts: int | None = None,
                           binary_out: np.ndarray | None = None,
                           logits_out: np.ndarray | None = None,
                           sigmoid_out: np.ndarray | None = None,
                           out_shape: tuple | None = None,
                           resume_state_path: str | None = None,
                           prefetch: bool = True, mesh=None,
                           mesh_axis: str = "sp"):
    """Stream a host (Z, Y, X) array (typically an ``np.memmap``) through the
    sliding-window engine on the model's device, in slabs of
    ``slab_z_starts`` window rows (None: ``slab_depth``).

    Finalized chunks go into ``binary_out`` / ``logits_out`` /
    ``sigmoid_out`` (each shaped ``out_shape``, the real unpadded extent;
    disk memmaps, typically: no full-volume host buffer is ever made). The
    logit and sigmoid outputs may be None. Returns (binary_out, logits_out).

    ``prefetch``: the next slab's slice and upload, and each chunk's copy
    back and writes, run on worker threads beside the compute; the output
    is the same bits either way.

    ``resume_state_path``: a JSON sidecar records the next slab after each
    chunk is written. A restart with a matching signature recomputes only
    the slabs that rebuild the on-device overlap carry and continues; a
    mismatched one starts from scratch. The sidecar is deleted on
    completion. The volume must be at least roi-sized.

    ``mesh``: a ``parallel.mesh.Mesh``; each slab's passes then run
    z-sharded over its ``mesh_axis`` devices (``sharded_accumulate`` on the
    slab, whose own window grid is its rows of the volume's), and the
    result is added into the slab's accumulators on the model's device:
    volumes past one card's memory use every card of the mesh."""
    device = next(model.parameters()).device
    if mesh is not None:
        require_shardable(model_cfg)
    roi = tuple(cfg.roi)
    z_img, y_img, x_img = volume.shape
    if any(volume.shape[i] < roi[i] for i in range(3)):
        raise ValueError(f"volume {volume.shape} is smaller than the roi {roi}")
    out_shape = tuple(volume.shape if out_shape is None else out_shape)
    real_z, real_y, real_x = out_shape
    interval = scan_interval(volume.shape, roi, cfg.overlap)
    z_starts = _dim_starts(z_img, roi[0], interval[0])
    ys = _dim_starts(y_img, roi[1], interval[1])
    xs = _dim_starts(x_img, roi[2], interval[2])
    if binary_out is None:
        binary_out = np.empty(out_shape, np.uint8)
    if slab_z_starts is None:
        slab_z_starts = slab_depth(cfg, model_cfg, volume.shape, volume.dtype.itemsize,
                                   device)
    n_slabs = -(-len(z_starts) // slab_z_starts)
    imp = _importance_for(cfg, device)
    batch = slab_batch_size(cfg, model_cfg, volume.shape, volume.dtype.itemsize,
                            slab_z_starts, device)
    shards = {} if mesh is None else {"spatial_shards": mesh.shape[mesh_axis]}
    sig = resume_signature(cfg, volume.shape, out_shape, slab_z_starts, batch, **shards)
    start_slab, regen_before_slab, finalized = _resume_point(
        resume_state_path, sig, z_starts, slab_z_starts, n_slabs, roi[0]
    )

    def bounds(i):
        sz = z_starts[i * slab_z_starts : (i + 1) * slab_z_starts]
        return sz[0], sz[-1] + roi[0]  # exclusive

    loader = _SlabLoader(volume, device, prefetch)
    writer = _ChunkWriter(device, prefetch, resume_state_path, sig)
    E = cfg.erosion_iters
    # The erosion context of a chunk, input > 0 over [write_lo − E,
    # write_hi + E), comes from the device slab, except the E planes below
    # it, which the previous slab carries forward (``ero_carry``: planes
    # [max(slab_z0 − E, 0), slab_z0), y/x-cropped): the input is not
    # uploaded twice. The top of the context stays inside the slab when
    # E ≤ roi_z − stride_z; deeper erosion reads the context from the host.
    ero_on_device = E <= roi[0] - interval[0]
    ero_carry = None
    carry_acc = carry_cnt = None  # planes [slab_z0, ...) of the next slab
    try:
        for slab_i in range(start_slab, n_slabs):
            with annotate("stream.slab"):
                slab_z0, slab_z1 = bounds(slab_i)
                vol, u16 = loader.take(slab_z0, slab_z1)
                if prefetch and slab_i + 1 < n_slabs:
                    loader.start(*bounds(slab_i + 1))
                starts_z = z_starts[slab_i * slab_z_starts : (slab_i + 1) * slab_z_starts]

                acc, cnt = _zero_accumulators(tuple(vol.shape), imp, device)
                if carry_acc is not None:
                    acc[: carry_acc.shape[0]].copy_(carry_acc)
                    cnt[: carry_cnt.shape[0]].copy_(carry_cnt)
                if mesh is None:
                    gen = torch.Generator(device=device)
                    gen.manual_seed(_slab_seed(cfg.seed, slab_i))
                    dims = [[z - slab_z0 for z in starts_z], ys, xs]
                    _accumulate(model, vol, u16, acc, cnt, dims, interval, gen, cfg,
                                batch, model_cfg, imp)
                else:
                    acc_s, cnt_s = sharded_accumulate(
                        mesh, model, vol, cfg, model_cfg, mesh_axis,
                        seed=_slab_seed(cfg.seed, slab_i), batch=batch, u16=u16,
                    )
                    acc += acc_s
                    cnt += cnt_s
                    del acc_s, cnt_s

                # voxels below the next slab's first window start get no more
                # contributions: [finalized, next_z0) is final
                next_z0 = (z_starts[(slab_i + 1) * slab_z_starts] if slab_i + 1 < n_slabs
                           else z_img)
                fin_hi = next_z0 - slab_z0
                nz = _nonzero(vol[:, :real_y, :real_x], u16) if ero_on_device else None
                if slab_i >= regen_before_slab:
                    # a regenerated slab's outputs are already on disk
                    write_lo, write_hi = finalized, min(next_z0, real_z)
                    pairs = []
                    if write_hi > write_lo:
                        with annotate("stream.finalize"):
                            lo = write_lo - slab_z0
                            sl = (slice(lo, lo + write_hi - write_lo), slice(0, real_y),
                                  slice(0, real_x))
                            mean = _divide(acc[sl], cnt[sl])
                            sig_c = torch.sigmoid(mean)
                            seg = (sig_c >= cfg.threshold).to(torch.uint8)
                            ctx_lo, ctx_hi = max(write_lo - E, 0), min(write_hi + E, real_z)
                            if ero_on_device:
                                lo_off = ctx_lo - slab_z0
                                ctx = nz[max(lo_off, 0) : ctx_hi - slab_z0]
                                if lo_off < 0:  # planes below the slab: the carry
                                    ctx = torch.cat([ero_carry[lo_off:], ctx])
                            else:
                                ctx = torch.from_numpy(
                                    np.asarray(volume[ctx_lo:ctx_hi, :real_y, :real_x]) > 0
                                ).to(device)
                            mask = binary_erosion_cross(ctx, E)[
                                write_lo - ctx_lo : write_hi - ctx_lo
                            ]
                            pairs.append((binary_out, seg * mask))
                            if sigmoid_out is not None:
                                pairs.append((sigmoid_out, sig_c))
                            if logits_out is not None:
                                pairs.append((logits_out, mean))
                    writer.submit(pairs, write_lo, write_hi, slab_i + 1, next_z0)
                finalized = next_z0

                if slab_i + 1 == n_slabs:
                    break
                # carry the tail [next_z0, slab_z1) forward to the head of the
                # next slab, which starts at next_z0; copies, so this slab's
                # accumulators are freed
                carry_acc, carry_cnt = acc[fin_hi:].clone(), cnt[fin_hi:].clone()
                del acc, cnt
                if ero_on_device:
                    lo = max(next_z0 - E, 0)
                    body = nz[max(lo, slab_z0) - slab_z0 : fin_hi]
                    if lo < slab_z0:
                        if ero_carry is None:
                            # resume: a regenerated slab has no carry chain; the
                            # planes below it come from the host volume
                            ero_carry = torch.from_numpy(
                                np.asarray(volume[lo:slab_z0, :real_y, :real_x]) > 0
                            ).to(device)
                        body = torch.cat([ero_carry[lo - slab_z0 :], body])
                    ero_carry = body.clone()
        writer.wait()
    finally:
        # no worker outlives the call, even when the compute loop raised
        loader.worker.close()
        writer.worker.close()

    # completed: drop the sidecar so a later forced re-run starts clean
    if resume_state_path and os.path.exists(resume_state_path):
        os.remove(resume_state_path)
    return binary_out, logits_out
