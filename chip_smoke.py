#!/usr/bin/env python3
"""Drive the PyTorch port (delivr_cfos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — needs CUDA; prints the card's name and power limit (nvidia-smi).
2. build   — builds every csrc/*.cu kernel with nvcc, all started together.
3. kernel  — conv3d_cs against its plain version at every conv shape of the
             production forward (BasicUNet features (32, 32, 64, 128, 256,
             32), window (96, 96, 64)) at the stage-2 window batch: with the
             stats output, in pair mode with the folded bias, once without
             stats and once with the affine prologue. Output within one bf16
             ULP (at max(|value|, rms of the output)), stats within rtol 1e-3.
             Times the kernel, the plain version and one cuDNN bf16
             F.conv3d (a yardstick only; the port never calls it).
4. model   — full-width fast forward (apply_cs) against the f32 parity
             BasicUNet on the same seeded weights, on volume windows.
5. stage2  — run_inference on the (192, 480, 384) uint16 half-bright volume
             with precision 'auto' (fast on CUDA) and TTA off, then parity;
             checks the kernel launch count, binaries.npy, and that fast and
             parity binaries differ only inside the measured logit margin;
             one more fast run under torch.profiler gives the device time by
             kernel (phase "profile").
6. the {"kernels": [...]} line, the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ROI = (96, 96, 64)
VOLUME = (192, 480, 384)
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(fn, reps: int = 3) -> float:
    """Warm once, then the mean of ``reps`` runs by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def conv_shapes(features, roi):
    """(name, level, C1, C2, C_out) of the 18 convs of one forward, in
    call order (C2 > 0: the UpCat's pair-mode conv)."""
    f = features
    rows = [("conv_0.0", 0, 1, 0, f[0]), ("conv_0.1", 0, f[0], 0, f[0])]
    for i in range(1, 5):
        rows += [(f"down_{i}.0", i, f[i - 1], 0, f[i]),
                 (f"down_{i}.1", i, f[i], 0, f[i])]
    for i, (skip, up, out) in zip(
        (4, 3, 2, 1),
        ((f[3], f[3], f[3]), (f[2], f[2], f[2]), (f[1], f[1], f[1]),
         (f[0], f[1], f[5])),
    ):
        rows += [(f"upcat_{i}.0", i - 1, skip, up, out),
                 (f"upcat_{i}.1", i - 1, out, 0, out)]
    return [(n, lvl, c1, c2, co, roi[0] >> lvl, roi[1] >> lvl, roi[2] >> lvl)
            for n, lvl, c1, c2, co in rows]


def bound_ms(b, d, s, cin, cout, emit_stats):
    flops = 2.0 * 27 * cin * cout * b * d * s
    nbytes = 2.0 * b * d * s * (cin + cout) + 2.0 * 27 * cin * cout
    if emit_stats:
        nbytes += 4.0 * b * d * 2 * cout
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ulp_error(got, want):
    """Largest |got − want| in bf16 ULPs at max(|value|, rms of want)."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()),
                        torch.tensor(max(rms, 2.0**-100), device=g.device))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max()), float((g - w).abs().max())


def check_conv(name, b, d, h, w, c1, c2, cout, *, emit_stats=True,
               affine=False, chunk=16):
    """One conv3d_cs case against the plain version (batch-chunked so the
    f32 reference fits beside the full-batch tensors); returns a row."""
    from delivr_cfos_tpu_torch.ops.conv3d_cs import conv3d_cs, conv3d_cs_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    s = h * w
    cin = c1 + c2
    x = torch.randn((b, d, c1, s), generator=g, device=dev).to(torch.bfloat16)
    wt = torch.randn((3, 3, 3, c1, cout), generator=g, device=dev) / math.sqrt(27 * cin)
    pair = None
    if c2:
        x2 = torch.randn((b, d, c2, s), generator=g, device=dev).to(torch.bfloat16)
        w2 = torch.randn((3, 3, 3, c2, cout), generator=g, device=dev) / math.sqrt(27 * cin)
        pair = (x2, w2, torch.randn((c2,), generator=g, device=dev) * 0.1)
    aff = None
    if affine:
        aff = (torch.rand((b, cin), generator=g, device=dev) + 0.5,
               torch.randn((b, cin), generator=g, device=dev) * 0.3)
    kw = dict(h=h, w=w, emit_stats=emit_stats, pair=pair, in_affine=aff)

    out = conv3d_cs(x, wt, None, **kw)
    torch.cuda.synchronize()
    got, st = out if emit_stats else (out, None)
    ulps = err = st_ratio = 0.0
    plain_ms = 0.0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, b, chunk):
        sl = slice(lo, min(lo + chunk, b))
        p = None if pair is None else (pair[0][sl], pair[1], pair[2])
        a = None if aff is None else (aff[0][sl], aff[1][sl])
        ev0.record()
        ref = conv3d_cs_reference(x[sl], wt, None, h=h, w=w,
                                  emit_stats=emit_stats, pair=p, in_affine=a)
        ev1.record()
        torch.cuda.synchronize()
        plain_ms += ev0.elapsed_time(ev1)
        want, st_want = ref if emit_stats else (ref, None)
        u, e = ulp_error(got[sl], want)
        ulps, err = max(ulps, u), max(err, e)
        if emit_stats:  # rtol 1e-3 plus atol 1e-3·max|Σ|: ratio ≤ 1 passes
            tol = 1e-3 * (st_want.abs() + float(st_want.abs().max()))
            st_ratio = max(st_ratio, float(((st[sl] - st_want).abs() / tol).max()))
        del ref, want, st_want
    ms = timed_ms(lambda: conv3d_cs(x, wt, None, **kw))

    # yardstick: one cuDNN bf16 conv of the same inputs, pre-laid-out NCDHW
    # (the concat of pair mode and the affine prologue already applied)
    xin = x if pair is None else torch.cat([x, pair[0]], dim=2)
    x5 = xin.reshape(b, d, cin, h, w).permute(0, 2, 1, 3, 4).contiguous()
    wcat = wt if pair is None else torch.cat([wt, pair[1]], dim=3)
    w5 = wcat.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()
    library_ms = timed_ms(lambda: torch.nn.functional.conv3d(x5, w5, padding=1))
    del x5, xin
    bms, by = bound_ms(b, d, s, cin, cout, emit_stats)
    row = dict(phase="kernel", case=name, b=b, d=d, h=h, w=w, c_in=cin,
               c_out=cout, pair=bool(c2), emit_stats=emit_stats, in_affine=affine,
               max_ulps=ulps, max_abs_err=err, stats_tol_ratio=st_ratio,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
               bound_by=by, tflops=2.0 * 27 * cin * cout * b * d * s / ms / 1e9)
    emit(row)
    if ulps > 1.0 or st_ratio > 1.0:
        raise AssertionError(f"conv3d_cs disagrees with its plain version: {row}")
    return row


def profile_summary(prof, wall_s, top=12):
    """Device time by kernel name from a torch.profiler trace: the busiest
    kernels and the device's busy share of the wall time."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are listed on their own
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    conv_ms = sum(r[0] for r in rows if "conv3d_cs" in r[2])
    return dict(phase="profile", wall_s=wall_s, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / 1e3 / wall_s,
                conv3d_cs_ms=conv_ms,
                top=[[name[:70], round(ms, 3), n] for ms, n, name in rows[:top]])


def make_volume():
    """(192, 480, 384) uint16: uniform 100..1000 in the low-y half, zeros in
    the other (the brain-like volume bench.py measures), from the seed."""
    rng = np.random.default_rng(SEED)
    z, y, x = VOLUME
    vol = np.zeros(VOLUME, np.uint16)
    vol[:, : y // 2] = (rng.random((z, y // 2, x), np.float32) * 900 + 100).astype(np.uint16)
    return vol


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from delivr_cfos_tpu_torch.config import PipelineConfig
    from delivr_cfos_tpu_torch.engine.sliding_window import (
        _forward_chunk_batches, auto_batch_size, dense_patch_starts,
    )
    from delivr_cfos_tpu_torch.models.basic_unet import (
        BasicUNetConfig, build_model, init_state_dict,
    )
    from delivr_cfos_tpu_torch.models.basic_unet_cs import apply_cs
    from delivr_cfos_tpu_torch.ops import _build
    from delivr_cfos_tpu_torch.ops.conv3d_cs import conv3d_cs
    from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda))

    emit(dict(phase="build", seconds=_build.build_all()))

    # --- 3. kernel vs plain at the main path's shapes ----------------------
    dev = torch.device("cuda")
    vol = make_volume()
    fast_cfg = BasicUNetConfig(precision="fast")
    batch = auto_batch_size(ROI, fast_cfg, vol.nbytes, device=dev)
    rows = [check_conv(n, batch, d, h, w, c1, c2, co)
            for n, _, c1, c2, co, d, h, w in conv_shapes(fast_cfg.features, ROI)]
    extra = [
        check_conv("conv_0.1/no_stats", batch, 96, 96, 64, 32, 0, 32, emit_stats=False),
        check_conv("down_1.1/in_affine", batch, 48, 48, 32, 32, 0, 32, affine=True),
    ]
    torch.cuda.empty_cache()

    # --- 4. full-width fast forward vs f32 parity ---------------------------
    sd = init_state_dict(BasicUNetConfig(), torch.Generator().manual_seed(SEED))
    model = build_model(sd, BasicUNetConfig(), dev)
    starts = dense_patch_starts(VOLUME, ROI, 0.5)
    bright = [s for s in starts if vol[s[0]:s[0] + ROI[0], s[1]:s[1] + ROI[1],
                                       s[2]:s[2] + ROI[2]].max() > 0]
    wins = np.stack([vol[z:z + ROI[0], y:y + ROI[1], x:x + ROI[2]]
                     for z, y, x in bright[:: max(1, len(bright) // 4)][:4]])
    xw = torch.from_numpy(wins.astype(np.float32))[..., None].to(dev)
    with torch.no_grad():
        fast = apply_cs(model, xw).float()
        parity = model(xw)
    dev_max = float((fast - parity).abs().max())
    scale = float(parity.abs().mean()) + 1e-3
    emit(dict(phase="model", windows=int(xw.shape[0]), max_abs_dev=dev_max,
              mean_abs_dev=float((fast - parity).abs().mean()),
              parity_mean_abs=scale - 1e-3, rel_dev=dev_max / scale,
              finite=bool(torch.isfinite(fast).all())))
    if not torch.isfinite(fast).all() or dev_max / scale >= 0.5:
        raise AssertionError("fast forward strays from parity beyond 0.5 × mean |logit|")
    del model, xw, fast, parity
    torch.cuda.empty_cache()

    # --- 5. stage 2 through run_inference -----------------------------------
    n_active = sum(
        1 for z, y, x in starts
        if vol[z:z + ROI[0], y:y + ROI[1], x:x + ROI[2]].max() > 0
    )
    chunk = _forward_chunk_batches(ROI, batch, dev) * batch
    n_batches = sum(math.ceil(min(chunk, n_active - lo) / batch)
                    for lo in range(0, n_active, chunk))
    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "in", "brain", "masked_niftis")
        os.makedirs(in_dir)
        mm = np.lib.format.open_memmap(os.path.join(in_dir, "masked_nifti.npy"),
                                       mode="w+", dtype=np.uint16,
                                       shape=(1, 1, *VOLUME))
        mm[0, 0] = vol
        mm.flush()
        del mm

        peak_gib = {}

        def run(precision, out):
            cfg = PipelineConfig.from_dict({
                "blob_detection": {
                    "input_location": os.path.join(tmp, "in"),
                    "output_location": os.path.join(tmp, out),
                    "window_dimensions": dict(zip(
                        ("window_dim_0", "window_dim_1", "window_dim_2"), ROI)),
                    "precision": precision,
                },
                "FLAGS": {"ABSPATHS": True, "TEST_TIME_AUGMENTATION": False,
                          "SAVE_ACTIVATED_OUTPUT": True},
            })
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            session = run_inference(cfg, "brain", (1, 1, *VOLUME), params=sd)
            seconds = time.perf_counter() - t0
            peak_gib[precision] = torch.cuda.max_memory_allocated() / 2**30
            bdir = os.path.join(session, "binary_segmentations")
            return (seconds, np.load(os.path.join(bdir, "binaries.npy")),
                    np.load(os.path.join(bdir, "network_output.npy")))

        conv3d_cs.launches = 0
        sec_fast, bin_fast, sig_fast = run("auto", "fast")
        launches = conv3d_cs.launches
        sec_fast_warm, _, _ = run("auto", "fast_warm")
        sec_parity, bin_par, sig_par = run("parity", "parity")

        # where stage 2's device time goes: one more fast run, traced
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            sec_traced, _, _ = run("auto", "fast_traced")
        emit(profile_summary(prof, sec_traced))

    flipped = bin_fast != bin_par
    margin = float(np.abs(sig_fast - sig_par).max())
    inside = bool((np.abs(sig_par[flipped] - 0.5) <= margin + 1e-6).all())
    n_vox = int(np.prod(VOLUME))
    emit(dict(phase="stage2", card=smi, volume=list(VOLUME), roi=list(ROI),
              windows=int(len(starts)), active_windows=n_active, batch=batch,
              forward_batches=n_batches, kernel_launches=launches,
              seconds_fast=sec_fast, seconds_fast_warm=sec_fast_warm,
              gvox_per_s_fast=n_vox / sec_fast_warm / 1e9,
              seconds_parity=sec_parity, gvox_per_s_parity=n_vox / sec_parity / 1e9,
              peak_gib_fast=peak_gib["auto"], peak_gib_parity=peak_gib["parity"],
              binaries_dtype=str(bin_fast.dtype), binaries_shape=list(bin_fast.shape),
              positives_fast=int(bin_fast.sum()), positives_parity=int(bin_par.sum()),
              flipped_voxels=int(flipped.sum()), sigmoid_margin=margin,
              flips_inside_margin=inside))
    if launches < 18 * n_batches:
        raise AssertionError(f"{launches} kernel launches < 18 × {n_batches} batches")
    if bin_fast.shape != VOLUME or bin_fast.dtype != np.uint8:
        raise AssertionError("binaries.npy has the wrong shape or dtype")
    if not (np.isfinite(sig_fast).all() and inside):
        raise AssertionError("fast binaries flip outside the fast-vs-parity margin")

    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    emit({"kernels": [{
        "name": "conv3d_cs",
        "route": "cuda",
        "source": "delivr_cfos_tpu_torch/csrc/conv3d_cs.cu",
        "replaces": "delivr_cfos_tpu/ops/pallas/conv3d_cs.py:374",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows + extra),
        # one forward batch: the sum over its 18 conv shapes
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations" if by_ops * 2 >= sum(r["bound_ms"] for r in rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
