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
             On the packed path (all but the C_in = 1 first conv) also
             conv3d_cs_pack against its plain version, bit for bit. Each row
             gives the path (packed / direct / gather), the conv kernel's ms
             and the pack's ms apart, their sum, the bounds, TFLOP/s, the
             plain versions' ms, one cuDNN bf16 F.conv3d and, for the pack,
             one F.pad of the channels-last view (yardsticks only; the port
             never calls them), the kernel's registers and blocks per SM; a
             "kernel_sum" line sums the 18 shapes. The first conv takes the
             direct kernel; a "conv_0.0/gather" row holds the gather kernel
             to the same check at the same shape, and times it.
   deconv  — deconv2x_cs against its plain version at the four UpCat shapes
             of the same forward at the same batch, and upcat_1 with a bias:
             within one bf16 ULP at max(|value|, rms). Times the wrapper as
             the model calls it (f32 weights, cast on every call), the plain
             version and one cuDNN bf16 F.conv_transpose3d on the input laid
             out NCDHW beforehand (a yardstick only): "ms" and "library_ms"
             are device time (the host queued ahead behind a spin),
             "call_ms" and "library_call_ms" calls back to back, host time
             included; each row gives the bound, the fraction of it reached
             (device time), the grid, the kernel's registers and blocks per
             SM; a "deconv_sum" line sums the five rows' times and bounds.
4. model   — full-width fast forward (apply_cs) against the f32 parity
             BasicUNet on the same seeded weights, on volume windows.
5. stage1  — stage 1 (pipeline/stage01_downsample_mask.py::downsample_mask)
             on 192 uncompressed uint16 TIFF planes of the (192, 480, 384)
             volume of phase 6 at the default ratios (4, 15, 15): first
             without a model (the Otsu branch), whose 8-bit stack gets a
             seeded scribble mask (bright half 1, empty half 2) for a forest
             fitted with fit_pixel_classifier (16 trees of depth 8, 20 000
             samples); then with that .npz on the card (device None) and
             with device="cpu". Every output file equal byte for byte
             between the two, except the mask and the files made from it,
             whose differing voxels are counted and held to MASK_FLIPS of
             the voxels; seconds by step (decode, downsample, features,
             forest, zoom, masking) and the peak device memory; the masked
             volume equal to the raw volume times mask_us.npy. Then
             predict_mask_probabilities on a seeded (324, 400, 467) 8-bit
             stack, the stage-1 stack of a (1300, 6000, 7000) raw brain at
             the default ratios, timed, and its first z-chunk against the
             CPU run (probabilities and uint8, the same bound). Last, stage
             2 fast on stage 1's masked_nifti.npy: 18 conv3d_cs (17 packed,
             1 direct), 17 conv3d_cs_pack and 4 deconv2x_cs launches per
             forward batch (counts set to 0 just before, read just after),
             no library convolution in a traced run, positives only inside
             the mask, and GVox/s.
6. stage2  — run_inference on the (192, 480, 384) uint16 half-bright volume
             with precision 'auto' (fast on CUDA) and TTA off, then parity;
             checks the kernel launch counts (18 conv3d_cs, of which 17
             packed and 1 direct, 17 conv3d_cs_pack and 4 deconv2x_cs per
             forward batch, no gather),
             binaries.npy, and that fast and parity binaries differ only
             inside the measured logit margin; one more fast run under
             torch.profiler gives the device time by kernel (phase
             "profile") and shows that no convolution or transposed
             convolution of the library ran, and no conv3d_cs_gather_kernel.
7. fused   — stage 2 in parity with BasicUNetConfig(fused_in_mish=True) on
             the same volume: 18 instance_norm_mish launches per forward
             batch, no conv3d_cs, binaries equal to phase 6's parity run
             wherever |logit| > 1e-3.
8. in_mish — instance_norm_mish against its plain version at the 18
             epilogue shapes of the full-width parity forward at the parity
             window batch in f32 (rtol 1e-4, atol 1e-5), and at the level-0
             and level-4 shapes in bf16 (one ULP at max(|value|, rms)).
             Times the kernel, the plain version and F.instance_norm +
             F.mish (a yardstick only; the port never calls them).
9. fallback — fast mode on 4 windows of (100, 100, 60), which do not divide
             by 16, with fused_in_mish: the bf16 forward on the bf16 kernel,
             against the f32 parity forward with phase 4's bound; then the
             bf16 kernel against its plain version (one ULP) at the 18
             epilogue shapes that forward gave it (phase "in_mish" rows and
             their "in_mish_fallback" sum).
10. stream — a (768, 480, 384) disk memmap: stage 2 fast streamed in 4 slabs
             (LOAD_ALL_RAM false), then in device memory; sigmoid within
             1e-5, binaries equal outside the 1e-3 logit band; then a resume
             from a hand-written sidecar at slab 2 over corrupted outputs,
             held to the same standard, with fewer conv3d_cs launches than
             the whole stream (a restart would launch as many); 17
             conv3d_cs_pack and 4 deconv2x_cs launches per 18 conv3d_cs in
             both; one more streamed run under
             torch.profiler gives the device's idle share.
11. stage3 — count_blobs on phase 6's fast binaries.npy in its three
             branches (in RAM native, in RAM slab-parallel, out of core): the
             CSV bytes, cache names and labels equal across branches, on the
             native engine; label_volume_device on the card over the same
             binaries equal to the host labels (seconds and rounds); stage 3
             out of core on phase 10's streamed binaries.
12. the {"kernels": [...]} line (conv3d_cs: the packed conv kernel,
             conv3d_cs_direct, conv3d_cs_pack, instance_norm_mish,
             deconv2x_cs), the nvidia-smi line, then the result line.

Every time, rate and memory figure is printed beside the card's name and
power limit (the "card" key).
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
PEAK_FP32_FLOPS = 67e12  # H100 SXM, f32 FMAs outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ROI = (96, 96, 64)
VOLUME = (192, 480, 384)
STREAM_VOLUME = (768, 480, 384)  # 15 window z-starts: 4 slabs of 4 rows
FALLBACK_WINDOW = (100, 100, 60)  # not divisible by 16
SEED = 0
SPIN_CYCLES = 50_000_000  # about 25 ms at the card's clock: device_ms's head start
BAND = 1e-3  # |logit| inside which sums in another order may flip a voxel
PACKED = 17  # convs of a forward on the packed path: all but the C_in = 1 first
# stage 1's 8-bit stack of a (1300, 6000, 7000) raw brain at the default
# ratios (4, 15, 15): ceil(1300 / 4) - 1, ceil(6000 / 15), ceil(7000 / 15)
BRAIN_STACK = (324, 400, 467)
MASK_FLIPS = 1e-4  # share of voxels in which the card's mask may differ from the CPU's


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


def device_ms(fn, reps: int = 10) -> float:
    """The device's time for one call, without the host's: warm once, queue
    a spin on the card that outlasts the host's enqueueing of ``reps`` calls,
    then the mean of the reps by CUDA events. Raises if the card reached the
    first call before the host had queued the last."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    if not ahead:
        raise AssertionError("the spin ended before the host had queued the calls")
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


def pack_bytes(b, d, h, w, cin):
    """Bytes the pack must move: the input read once, xp written once."""
    return 2.0 * b * d * h * w * cin + 2.0 * b * (d + 2) * (h + 2) * (w + 2) * cin


def check_conv(card, name, b, d, h, w, c1, c2, cout, *, emit_stats=True,
               affine=False, gather=False, chunk=16):
    """One conv3d_cs case against the plain version (batch-chunked so the
    f32 reference fits beside the full-batch tensors); on the packed path
    also the pack against its plain version, bit for bit. ``gather`` runs
    the gather kernel whatever the shape. Returns a row."""
    from delivr_cfos_tpu_torch.ops.conv3d_cs import (
        block_weights, conv3d_cs, conv3d_cs_gather, conv3d_cs_pack,
        conv3d_cs_pack_reference, conv3d_cs_packed, conv3d_cs_path,
        conv3d_cs_reference, conv3d_cs_resources, kernel_weights,
    )

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
    path = "gather" if gather else conv3d_cs_path(c1, c2, w, cout)
    conv = conv3d_cs_gather if gather else conv3d_cs
    pk = dict(h=h, w=w, x2=None if pair is None else pair[0],
              bias2=None if pair is None else pair[2], in_affine=aff)

    out = conv(x, wt, None, **kw)
    torch.cuda.synchronize()
    got, st = out if emit_stats else (out, None)
    ulps = err = st_ratio = 0.0
    plain_ms = pack_plain_ms = pack_err = 0.0
    pack_equal = None
    xp = conv3d_cs_pack(x, **pk) if path == "packed" else None
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
        if xp is not None:
            ev0.record()
            xp_want = conv3d_cs_pack_reference(
                x[sl], h=h, w=w, x2=None if p is None else p[0],
                bias2=None if p is None else p[2], in_affine=a)
            ev1.record()
            torch.cuda.synchronize()
            pack_plain_ms += ev0.elapsed_time(ev1)
            same = torch.equal(xp[sl].view(torch.int16), xp_want.view(torch.int16))
            pack_equal = same if pack_equal is None else pack_equal and same
            pack_err = max(pack_err, float((xp[sl].float() - xp_want.float()).abs().max()))
            del xp_want
    del got, st, out
    ms = timed_ms(lambda: conv(x, wt, None, **kw))
    pack_ms = None
    kernel_ms = ms
    if xp is not None:
        w_blk = block_weights(kernel_weights(wt, None if pair is None else pair[1]))
        pack_ms = timed_ms(lambda: conv3d_cs_pack(x, **pk))
        kernel_ms = timed_ms(lambda: conv3d_cs_packed(xp, w_blk, None, cout=cout,
                                                      emit_stats=emit_stats))
    del xp

    # yardsticks: one cuDNN bf16 conv of the same inputs, pre-laid-out NCDHW,
    # and for the pack one F.pad of the channels-last view (the concat of
    # pair mode and the affine prologue already applied in both)
    xin = x if pair is None else torch.cat([x, pair[0]], dim=2)
    x5 = xin.reshape(b, d, cin, h, w).permute(0, 2, 1, 3, 4).contiguous()
    wcat = wt if pair is None else torch.cat([wt, pair[1]], dim=3)
    w5 = wcat.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()
    library_ms = timed_ms(lambda: torch.nn.functional.conv3d(x5, w5, padding=1))
    del x5
    pack_library_ms = None
    if path == "packed":
        xcl = xin.view(b, d, cin, h, w).permute(0, 1, 3, 4, 2)
        pack_library_ms = timed_ms(
            lambda: torch.nn.functional.pad(xcl, (0, 0, 1, 1, 1, 1, 1, 1)))
        del xcl
    del xin
    bms, by = bound_ms(b, d, s, cin, cout, emit_stats)
    flops = 2.0 * 27 * cin * cout * b * d * s
    regs, blocks_per_sm = conv3d_cs_resources(path, h, w)
    sum_ms = kernel_ms + (pack_ms or 0.0)
    row = dict(phase="kernel", card=card, case=name, path=path, b=b, d=d, h=h, w=w,
               c_in=cin, c_out=cout, pair=bool(c2), emit_stats=emit_stats,
               in_affine=affine, max_ulps=ulps, max_abs_err=err,
               stats_tol_ratio=st_ratio, pack_equal=pack_equal,
               pack_max_abs_err=pack_err if path == "packed" else None,
               kernel_ms=kernel_ms, pack_ms=pack_ms, ms=sum_ms, wrapper_ms=ms,
               plain_ms=plain_ms, pack_plain_ms=pack_plain_ms,
               library_ms=library_ms, pack_library_ms=pack_library_ms,
               bound_ms=bms, bound_by=by,
               # the direct kernel's FMAs on the f32 pipe, beside the bound
               fp32_pipe_ms=1e3 * flops / PEAK_FP32_FLOPS if path == "direct" else None,
               pack_bound_ms=1e3 * pack_bytes(b, d, h, w, cin) / PEAK_BYTES
               if path == "packed" else None,
               tflops=flops / sum_ms / 1e9, kernel_tflops=flops / kernel_ms / 1e9,
               registers=regs, blocks_per_sm=blocks_per_sm)
    emit(row)
    if ulps > 1.0 or st_ratio > 1.0:
        raise AssertionError(f"conv3d_cs disagrees with its plain version: {row}")
    if path == "packed" and not pack_equal:
        raise AssertionError(f"conv3d_cs_pack differs from its plain version: {row}")
    return row


def deconv_shapes(features, roi):
    """(name, D, H, W, C, O) of the four UpCat deconvs of one forward, in
    call order: the input's level and channels, the UpCat's channels."""
    f = features
    rows = [("upcat_4", 4, f[4], f[3]), ("upcat_3", 3, f[3], f[2]),
            ("upcat_2", 2, f[2], f[1]), ("upcat_1", 1, f[1], f[1])]
    return [(n, roi[0] >> lvl, roi[1] >> lvl, roi[2] >> lvl, c, o)
            for n, lvl, c, o in rows]


def check_deconv(card, name, b, d, h, w, c, o, *, with_bias=False, chunk=16):
    """One deconv2x_cs case against the plain version (batch-chunked so the
    f32 reference fits beside the full-batch tensors); returns a row."""
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import (
        deconv2x_cs, deconv2x_cs_plan, deconv2x_cs_reference, deconv2x_cs_resources,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    x = torch.randn((b, d, c, h * w), generator=g, device=dev).to(torch.bfloat16)
    wt = torch.randn((c, o, 2, 2, 2), generator=g, device=dev) / math.sqrt(8 * c)
    bias = torch.randn((o,), generator=g, device=dev) * 0.1 if with_bias else None

    got = deconv2x_cs(x, wt, bias, h=h, w=w)
    deconv2x_cs_reference(x[:1], wt, bias, h=h, w=w)  # warm: cuBLAS's set-up
    torch.cuda.synchronize()
    ulps = err = plain_ms = 0.0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, b, chunk):
        sl = slice(lo, min(lo + chunk, b))
        ev0.record()
        want = deconv2x_cs_reference(x[sl], wt, bias, h=h, w=w)
        ev1.record()
        torch.cuda.synchronize()
        plain_ms += ev0.elapsed_time(ev1)
        u, e = ulp_error(got[sl], want)
        ulps, err = max(ulps, u), max(err, e)
        del want
    finite = bool(torch.isfinite(got.float()).all())
    del got
    # 10 runs: the small UpCats take a fraction of a millisecond. Each call
    # gets what the model's UpCat passes, a fresh f32 view of the weights,
    # so it holds the cast to bf16. ms is the device's time (cast and
    # kernel); call_ms, calls back to back, holds the wrapper's host time.
    def call():
        return deconv2x_cs(x, wt.detach(), bias, h=h, w=w)

    ms, call_ms = device_ms(call, reps=10), timed_ms(call, reps=10)

    # yardstick: one cuDNN bf16 transposed conv of the same inputs, laid out
    # NCDHW beforehand (its output is NCDHW, not the kernel's layout), timed
    # both ways
    x5 = x.reshape(b, d, c, h, w).permute(0, 2, 1, 3, 4).contiguous()
    w5 = wt.to(torch.bfloat16)
    b5 = None if bias is None else bias.to(torch.bfloat16)

    def library():
        return torch.nn.functional.conv_transpose3d(x5, w5, b5, stride=2)

    library_ms, library_call_ms = device_ms(library, reps=10), timed_ms(library, reps=10)
    del x5
    # x read once, the output written once, the weights and bias read once
    nbytes = (2.0 * b * d * h * w * (c + 8 * o) + 2.0 * 8 * c * o
              + (4.0 * o if with_bias else 0.0))
    flops = 2.0 * b * d * h * w * c * 8 * o
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    plan = deconv2x_cs_plan(b * d, h, w, o, x_aligned=x.data_ptr() % 16 == 0,
                            sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    regs, blocks_per_sm = deconv2x_cs_resources(plan.vec_in, plan.fast_out)
    bms = 1e3 * max(t_ops, t_bytes)
    row = dict(phase="deconv", card=card, case=name + ("/bias" if with_bias else ""),
               b=b, d=d, h=h, w=w, c_in=c, c_out=o, bias=with_bias, max_ulps=ulps,
               max_abs_err=err, finite=finite, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_call_ms=library_call_ms, bound_ms=bms,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               fraction_of_bound=bms / ms, gbytes_per_s=nbytes / ms / 1e6,
               grid=[plan.n_tiles, plan.m_blocks], registers=regs,
               blocks_per_sm=blocks_per_sm)
    emit(row)
    if ulps > 1.0 or not finite:
        raise AssertionError(f"deconv2x_cs disagrees with its plain version: {row}")
    return row


# names of the library's transposed-convolution kernels (cuDNN runs it as
# the data gradient of a convolution) and of the aten ops that reach them
TRANSPOSED_CONV_KERNELS = ("dgrad", "convtranspose", "conv_transpose", "col2im", "col2vol")
TRANSPOSED_CONV_OPS = ("aten::conv_transpose3d", "aten::cudnn_convolution_transpose",
                       "aten::slow_conv_transpose3d")
# the aten ops through which any library convolution runs, and cuDNN's
# forward-convolution kernel names
LIBRARY_CONV_OPS = ("aten::convolution", "aten::_convolution", "aten::cudnn_convolution")
LIBRARY_CONV_KERNELS = ("fprop", "implicit_gemm", "implicit_convolve", "conv2d", "conv3d_")


def profile_summary(prof, wall_s, top=12):
    """Device time by kernel name from a torch.profiler trace: the busiest
    kernels, the device's busy share of the wall time, and any convolution
    or transposed convolution of the library."""
    rows = []
    transposed = []
    library_conv = []
    for ev in prof.key_averages():
        if ev.key in TRANSPOSED_CONV_OPS and ev.count:
            transposed.append([ev.key, ev.count])
        if ev.key in LIBRARY_CONV_OPS and ev.count:
            library_conv.append([ev.key, ev.count])
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are listed on their own
        if any(k in ev.key.lower() for k in TRANSPOSED_CONV_KERNELS):
            transposed.append([ev.key[:70], ev.count])
        if any(k in ev.key.lower() for k in LIBRARY_CONV_KERNELS) and "conv3d_cs" not in ev.key:
            library_conv.append([ev.key[:70], ev.count])
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    pack_ms = sum(r[0] for r in rows if "conv3d_cs_pack_kernel" in r[2])
    conv_ms = sum(r[0] for r in rows if "conv3d_cs" in r[2]) - pack_ms
    direct = [r for r in rows if "conv3d_cs_direct_kernel" in r[2]]
    deconv_ms = sum(r[0] for r in rows if "deconv2x_cs" in r[2])
    return dict(phase="profile", wall_s=wall_s, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / 1e3 / wall_s,
                conv3d_cs_ms=conv_ms, conv3d_cs_pack_ms=pack_ms,
                conv3d_cs_direct_ms=sum(r[0] for r in direct),
                conv3d_cs_direct_launches=sum(r[1] for r in direct),
                gather_kernel=[[r[2][:70], r[1]] for r in rows
                               if "conv3d_cs_gather_kernel" in r[2]],
                deconv2x_cs_ms=deconv_ms, library_transposed_conv=transposed,
                library_conv=library_conv,
                top=[[name[:70], round(ms, 3), n] for ms, n, name in rows[:top]])


def make_volume(shape=VOLUME):
    """uint16: uniform 100..1000 in the low-y half, zeros in the other (the
    brain-like volume bench.py measures at (192, 480, 384)), from the seed."""
    rng = np.random.default_rng(SEED)
    z, y, x = shape
    vol = np.zeros(shape, np.uint16)
    vol[:, : y // 2] = (rng.random((z, y // 2, x), np.float32) * 900 + 100).astype(np.uint16)
    return vol


def write_brain(root, vol):
    """The stage-1 output layout run_inference reads, as a disk memmap."""
    in_dir = os.path.join(root, "in", "brain", "masked_niftis")
    os.makedirs(in_dir)
    mm = np.lib.format.open_memmap(os.path.join(in_dir, "masked_nifti.npy"),
                                   mode="w+", dtype=np.uint16,
                                   shape=(1, 1, *vol.shape))
    mm[0, 0] = vol
    mm.flush()


def pipeline_config(root, out, precision="auto", load_all_ram=True):
    """The stage-2 config of a run over ``root``'s brain into ``out``."""
    from delivr_cfos_tpu_torch.config import PipelineConfig

    return PipelineConfig.from_dict({
        "blob_detection": {
            "input_location": os.path.join(root, "in"),
            "output_location": os.path.join(root, out),
            "window_dimensions": dict(zip(
                ("window_dim_0", "window_dim_1", "window_dim_2"), ROI)),
            "precision": precision,
        },
        "FLAGS": {"ABSPATHS": True, "TEST_TIME_AUGMENTATION": False,
                  "SAVE_ACTIVATED_OUTPUT": True, "LOAD_ALL_RAM": load_all_ram},
    })


def stage2(root, out, sd, precision="auto", load_all_ram=True, model_cfg=None):
    """One run_inference over ``root``'s brain into ``out``: (seconds, peak
    device GiB, binaries, sigmoid outputs)."""
    from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference

    cfg = pipeline_config(root, out, precision, load_all_ram)
    shape = np.load(os.path.join(root, "in", "brain", "masked_niftis",
                                 "masked_nifti.npy"), mmap_mode="r").shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = run_inference(cfg, "brain", shape, params=sd, model_cfg=model_cfg)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    bdir = os.path.join(session, "binary_segmentations")
    return (seconds, peak, np.load(os.path.join(bdir, "binaries.npy")),
            np.load(os.path.join(bdir, "network_output.npy")))


def logit_of(sig):
    s = sig.astype(np.float64)
    return np.log(np.clip(s, 1e-300, None)) - np.log(np.clip(1 - s, 1e-300, None))


def forward_batches(vol, batch, device):
    """Forward batches the in-memory engine runs over ``vol``'s active
    windows (TTA off)."""
    from delivr_cfos_tpu_torch.engine.sliding_window import (
        _forward_chunk_batches, dense_patch_starts,
    )

    n_active = sum(
        1 for z, y, x in dense_patch_starts(vol.shape, ROI, 0.5)
        if vol[z:z + ROI[0], y:y + ROI[1], x:x + ROI[2]].max() > 0
    )
    chunk = _forward_chunk_batches(ROI, batch, device) * batch
    return n_active, sum(math.ceil(min(chunk, n_active - lo) / batch)
                         for lo in range(0, n_active, chunk))


def check_in_mish(card, name, n, c, d, h, w, dtype, chunk=8):
    """One instance_norm_mish case against the plain version (batch-chunked
    so the f32 reference fits beside the full-batch tensors); returns a
    row."""
    from delivr_cfos_tpu_torch.ops.instance_norm_mish import (
        instance_norm_mish, instance_norm_mish_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    x = (torch.randn((n, c, d, h, w), generator=g, device=dev) * 2 + 0.3).to(dtype)
    scale = torch.rand((c,), generator=g, device=dev) + 0.5
    bias = torch.randn((c,), generator=g, device=dev) * 0.2
    got = instance_norm_mish(x, scale, bias)
    torch.cuda.synchronize()
    err = ratio = ulps = plain_ms = 0.0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        ev0.record()
        want = instance_norm_mish_reference(x[sl], scale, bias)
        ev1.record()
        torch.cuda.synchronize()
        plain_ms += ev0.elapsed_time(ev1)
        diff = (got[sl].float() - want.float()).abs()
        err = max(err, float(diff.max()))
        if dtype == torch.float32:  # rtol 1e-4, atol 1e-5: ratio ≤ 1 passes
            ratio = max(ratio, float((diff / (1e-5 + 1e-4 * want.abs())).max()))
        else:
            ulps = max(ulps, ulp_error(got[sl], want)[0])
        del want, diff
    finite = bool(torch.isfinite(got.float()).all())
    ms = timed_ms(lambda: instance_norm_mish(x, scale, bias))
    # yardstick: two library calls, which the port never makes
    sc, bi = scale.to(dtype), bias.to(dtype)
    library_ms = timed_ms(lambda: torch.nn.functional.mish(
        torch.nn.functional.instance_norm(x, weight=sc, bias=bi, eps=1e-5)))
    nbytes = 2.0 * x.numel() * x.element_size()
    row = dict(phase="in_mish", card=card, case=name, shape=[n, c, d, h, w],
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
               tol_ratio=ratio, max_ulps=ulps, finite=finite, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
               gbytes_per_s=nbytes / ms / 1e6)
    emit(row)
    if ratio > 1.0 or ulps > 1.0 or not finite:
        raise AssertionError(f"instance_norm_mish disagrees with its plain version: {row}")
    del x, got
    return row


def stream_phase(card, sd, dev):
    """Phase 10: stage 2 fast streamed from a disk memmap, then in device
    memory on the same file, then resumed from a hand-written sidecar.
    Returns the streamed binaries."""
    from delivr_cfos_tpu_torch.engine import streaming
    from delivr_cfos_tpu_torch.engine.sliding_window import (
        auto_batch_size, dense_patch_starts,
    )
    from delivr_cfos_tpu_torch.ops.conv3d_cs import (
        conv3d_cs, conv3d_cs_direct, conv3d_cs_gather, conv3d_cs_pack,
    )
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import deconv2x_cs
    from delivr_cfos_tpu_torch.pipeline.stage02_inference import (
        resolve_model_config, sliding_window_config,
    )

    def reset():
        conv3d_cs.launches = deconv2x_cs.launches = conv3d_cs_pack.launches = 0
        conv3d_cs_direct.launches = conv3d_cs_gather.launches = 0

    def counts():
        return (conv3d_cs.launches, conv3d_cs_pack.launches, deconv2x_cs.launches,
                conv3d_cs_direct.launches, conv3d_cs_gather.launches)

    svol = make_volume(STREAM_VOLUME)
    z_starts = sorted({int(z) for z, _, _ in dense_patch_starts(STREAM_VOLUME, ROI, 0.5)})
    k = streaming.SLAB_Z_STARTS
    with tempfile.TemporaryDirectory() as tmp:
        # the window config, model config and batch run_inference resolves
        # for the streamed run, so that the hand-written sidecar matches
        pcfg = pipeline_config(tmp, "stream", load_all_ram=False)
        sw_cfg = sliding_window_config(pcfg)
        fast_cfg, _ = resolve_model_config(pcfg.blob_detection, sd, dev)
        slab_batch = streaming.slab_batch_size(
            sw_cfg, fast_cfg, STREAM_VOLUME, svol.itemsize, k, dev)
        mem_batch = auto_batch_size(ROI, fast_cfg, svol.nbytes, device=dev)
        write_brain(tmp, svol)
        del svol
        reset()
        sec_st, peak_st, bin_st, sig_st = stage2(tmp, "stream", sd, load_all_ram=False)
        stream_counts = counts()
        stream_launches, stream_pack, stream_deconv = stream_counts[:3]
        sec_mem, peak_mem, bin_mem, sig_mem = stage2(tmp, "memory", sd)

        # resume: the sidecar an interruption after slab 1 leaves, over
        # outputs corrupted beyond it; a resume runs fewer forward batches
        # than the whole stream (a mismatched sidecar would restart)
        bdir = os.path.join(tmp, "stream", "brain", "binary_segmentations")
        finalized = z_starts[2 * k]
        with open(os.path.join(bdir, "streaming_resume.json"), "w") as f:
            json.dump({"sig": streaming.resume_signature(
                sw_cfg, STREAM_VOLUME, STREAM_VOLUME, k, slab_batch),
                "next_slab": 2, "finalized": finalized}, f)
        for name, bad in (("binaries.npy", 255), ("network_output.npy", -1.0)):
            mm = np.load(os.path.join(bdir, name), mmap_mode="r+")
            mm[finalized:] = bad
            mm.flush()
            del mm
        reset()
        sec_res, _, bin_res, sig_res = stage2(tmp, "stream", sd, load_all_ram=False)
        res_counts = counts()
        res_launches, res_pack, res_deconv = res_counts[:3]
        resumed = (0 < res_launches < stream_launches and not os.path.exists(
            os.path.join(bdir, "streaming_resume.json")))

        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            sec_traced, _, _, _ = stage2(tmp, "stream_traced", sd, load_all_ram=False)
        emit(dict(profile_summary(prof, sec_traced), card=card, run="stream fast"))
        del prof

    band = np.abs(logit_of(sig_mem)) <= BAND
    s_vox = int(np.prod(STREAM_VOLUME))
    sig_dev = float(np.abs(sig_st - sig_mem).max())
    res_dev = float(np.abs(sig_res - sig_st).max())
    ok_st = sig_dev <= 1e-5 and bool((bin_st[~band] == bin_mem[~band]).all())
    ok_res = res_dev <= 1e-5 and bool((bin_res[~band] == bin_st[~band]).all())
    emit(dict(phase="stream", card=card, volume=list(STREAM_VOLUME),
              z_starts=len(z_starts), slabs=-(-len(z_starts) // k),
              conv3d_cs_launches=stream_launches, resume_conv3d_cs_launches=res_launches,
              deconv2x_cs_launches=stream_deconv, resume_deconv2x_cs_launches=res_deconv,
              conv3d_cs_pack_launches=stream_pack, resume_conv3d_cs_pack_launches=res_pack,
              conv3d_cs_direct_launches=stream_counts[3],
              resume_conv3d_cs_direct_launches=res_counts[3],
              conv3d_cs_gather_launches=stream_counts[4] + res_counts[4],
              batch_stream=slab_batch, batch_memory=mem_batch,
              seconds_stream=sec_st, gvox_per_s_stream=s_vox / sec_st / 1e9,
              peak_gib_stream=peak_st, seconds_memory=sec_mem,
              gvox_per_s_memory=s_vox / sec_mem / 1e9, peak_gib_memory=peak_mem,
              max_sigmoid_dev=sig_dev, voxels_in_band=int(band.sum()),
              differing_voxels=int((bin_st != bin_mem).sum()),
              positives=int(bin_st.sum()), seconds_resume=sec_res,
              resume_max_sigmoid_dev=res_dev, resume_bit_identical=bool(
                  np.array_equal(bin_res, bin_st) and np.array_equal(sig_res, sig_st)),
              resumed=resumed))
    if stream_launches < 18:
        raise AssertionError("the streamed stage 2 launched no conv3d_cs")
    # 18 convs (1 direct, none gathered), 17 packs and 4 deconvs per forward
    # batch, the resume fewer
    for conv, pack, deconv, direct, gathered in (stream_counts, res_counts):
        if (conv % 18 or deconv != 4 * (conv // 18) or pack != PACKED * (conv // 18)
                or direct != conv // 18 or gathered):
            raise AssertionError(
                f"streamed stage 2: {deconv} deconv2x_cs, {pack} conv3d_cs_pack, "
                f"{direct} direct and {gathered} gather launches for {conv} conv3d_cs")
    if not 0 < res_deconv < stream_deconv:
        raise AssertionError("the resumed stream did not launch fewer deconv2x_cs")
    if not (ok_st and np.isfinite(sig_st).all() and bin_st.shape == STREAM_VOLUME):
        raise AssertionError("streamed stage 2 disagrees with the in-memory run")
    if not (ok_res and resumed):
        raise AssertionError("the resumed stream disagrees with the uninterrupted one")

    return bin_st


def stage1_config(raw, out, model):
    """Stage 1 over ``raw``'s brain into ``out`` with the forest at ``model``
    (the Otsu fallback where that file does not exist), default ratios."""
    from delivr_cfos_tpu_torch.config import PipelineConfig

    return PipelineConfig.from_dict({
        "raw_location": raw,
        "mask_detection": {"output_location": out + os.sep, "ilastik_model": model,
                           "mask_with_Ilastik": True},
        "blob_detection": {"window_dimensions": dict(zip(
            ("window_dim_0", "window_dim_1", "window_dim_2"), ROI))},
        "FLAGS": {"ABSPATHS": True},
    })


def tree_files(root):
    """{path relative to ``root``: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def read_output(path):
    """The array in one stage-1 output file."""
    from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff
    from delivr_cfos_tpu_torch.utils.io.v3draw import read_v3draw

    if path.endswith(".npy"):
        return np.load(path)
    return read_v3draw(path) if path.endswith(".v3draw") else read_tiff(path)


def brain_stack():
    """A seeded 8-bit stack of a downsampled brain at BRAIN_STACK: an
    ellipsoid of bright noise in an empty volume, as make_volume's bright
    half in its empty one."""
    rng = np.random.default_rng(SEED)
    z, y, x = BRAIN_STACK
    st = np.zeros(BRAIN_STACK, np.uint8)
    zz, yy, xx = np.ogrid[:z, :y, :x]
    inside = (((zz - z / 2) / (z / 2.2)) ** 2 + ((yy - y / 2) / (y / 2.3)) ** 2
              + ((xx - x / 2) / (x / 2.3)) ** 2) < 1
    st[inside] = (120 + rng.random(int(inside.sum()), np.float32) * 100).astype(np.uint8)
    return st


def stage1_phase(card, vol, sd, batch, dev):
    """Phase 5: stage 1 on the card against the CPU, the mask model at a real
    brain's size, and stage 2 fast on stage 1's output."""
    from delivr_cfos_tpu_torch.models.pixel_classifier import (
        fit_pixel_classifier, predict_mask_probabilities, predict_probabilities, save_model,
    )
    from delivr_cfos_tpu_torch.native.build import native_available
    from delivr_cfos_tpu_torch.ops.conv3d_cs import (
        conv3d_cs, conv3d_cs_direct, conv3d_cs_gather, conv3d_cs_pack, conv3d_cs_packed,
    )
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import deconv2x_cs
    from delivr_cfos_tpu_torch.pipeline.stage01_downsample_mask import downsample_mask
    from delivr_cfos_tpu_torch.utils.device import StepSeconds
    from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff, write_tiff

    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        os.makedirs(os.path.join(raw, "brain"))
        for z in range(vol.shape[0]):
            write_tiff(os.path.join(raw, "brain", f"Z{z:04d}.tif"), vol[z])
        model_path = os.path.join(tmp, "forest.npz")

        # the Otsu branch (no model file yet) gives the phase's own 8-bit stack
        t0 = time.perf_counter()
        downsample_mask(stage1_config(raw, os.path.join(tmp, "otsu"), model_path), "brain")
        sec_otsu = time.perf_counter() - t0
        st8 = read_tiff(os.path.join(tmp, "otsu", "brain", "stack_resampled_8bit.tif"))
        rng = np.random.default_rng(SEED)
        bright = np.zeros(st8.shape, bool)
        bright[:, : -(-st8.shape[1] // 2)] = True  # make_volume's bright low-y half
        labels = np.where(rng.random(st8.shape) < 0.1, np.where(bright, 1, 2), 0)
        t0 = time.perf_counter()
        model = fit_pixel_classifier([st8], [labels.astype(np.uint8)], max_samples=20_000,
                                     seed=SEED, device=dev)
        sec_fit = time.perf_counter() - t0
        save_model(model_path, model)

        # the forest branch: on the card as a user calls it, then on the CPU
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps = downsample_mask(stage1_config(raw, os.path.join(tmp, "in"), model_path),
                                "brain")
        sec_card = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        cpu_steps = downsample_mask(stage1_config(raw, os.path.join(tmp, "cpu"), model_path),
                                    "brain", device="cpu")
        sec_cpu = time.perf_counter() - t0

        card_files = tree_files(os.path.join(tmp, "in"))
        cpu_files = tree_files(os.path.join(tmp, "cpu"))
        from_mask = ("_mask.tif", "mask_us.npy", "masked")
        differing, flips = [], {}
        for name in sorted(set(card_files) | set(cpu_files)):
            if card_files.get(name) == cpu_files.get(name):
                continue
            differing.append(name)
            if any(k in name for k in from_mask) and name in card_files \
                    and name in cpu_files:
                a = read_output(os.path.join(tmp, "in", name))
                b = read_output(os.path.join(tmp, "cpu", name))
                flips[name] = int((a != b).sum()) if a.shape == b.shape else -1
        mask_us = np.load(os.path.join(tmp, "in", "brain", "mask_us.npy"))
        nii_path = os.path.join(tmp, "in", "brain", "masked_niftis", "masked_nifti.npy")
        nii = np.load(nii_path)
        masked_ok = nii.shape == (1, 1, *VOLUME) and np.array_equal(nii[0, 0], vol * mask_us)

        # the mask model at a real brain's size
        big = brain_stack()
        timer = StepSeconds(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        big255 = predict_mask_probabilities(big, model_path, device=dev, timer=timer)
        sec_big = time.perf_counter() - t0
        peak_big = torch.cuda.max_memory_allocated() / 2**30
        head = big[:48]  # the first z-chunk of 32 planes and its 16-plane halo
        p_card = predict_probabilities(head, model, device=dev)[:32]
        p_cpu = predict_probabilities(head, model, device="cpu")[:32]
        u8_cpu = predict_mask_probabilities(head, model_path, device="cpu")[:32]

        # stage 2 fast on stage 1's masked_nifti.npy
        masked = nii[0, 0]
        n_active, n_batches = forward_batches(masked, batch, dev)
        conv3d_cs.launches = deconv2x_cs.launches = conv3d_cs_pack.launches = 0
        conv3d_cs_packed.launches = conv3d_cs_direct.launches = conv3d_cs_gather.launches = 0
        sec_s2, peak_s2, bin_s2, sig_s2 = stage2(tmp, "fast_s1", sd)
        counts = (conv3d_cs.launches, conv3d_cs_packed.launches, conv3d_cs_direct.launches,
                  conv3d_cs_gather.launches, conv3d_cs_pack.launches, deconv2x_cs.launches)
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            sec_traced, _, _, _ = stage2(tmp, "fast_s1_traced", sd)
        s1_profile = profile_summary(prof, sec_traced)
        emit(dict(s1_profile, card=card, run="stage2 fast on stage 1's output"))
        del prof

    n_vox = int(np.prod(VOLUME))
    big_flips = int((p_card != p_cpu).sum())
    emit(dict(phase="stage1", card=card, raw=list(VOLUME), ratios=[4, 15, 15],
              downsampled=list(st8.shape), tiff_codec_native=native_available("tiff_codec"),
              seconds_otsu_run=sec_otsu, seconds_fit=sec_fit, seconds=sec_card,
              seconds_by_step=steps, peak_gib=peak, seconds_cpu=sec_cpu,
              seconds_by_step_cpu=cpu_steps, files=len(card_files),
              files_differing=differing, voxels_differing=flips,
              mask_voxels=int(mask_us.sum()), masked_equals_raw_times_mask=bool(masked_ok),
              brain_stack=list(BRAIN_STACK), brain_seconds=sec_big,
              brain_seconds_by_step=dict(timer), brain_peak_gib=peak_big,
              brain_gvox_per_s=int(np.prod(BRAIN_STACK)) / sec_big / 1e9,
              brain_foreground=float((big255 >= 125).mean()),
              chunk_voxels=int(p_card.size), chunk_voxels_differing=big_flips,
              chunk_max_abs_err=float(np.abs(p_card - p_cpu).max()),
              chunk_uint8_differing=int((big255[:32] != u8_cpu).sum())))
    conv, packed, direct, gathered, pack, deconv = counts
    emit(dict(phase="stage1_stage2", card=card, volume=list(VOLUME), batch=batch,
              active_windows=n_active, forward_batches=n_batches, kernel_launches=conv,
              conv3d_cs_packed_launches=packed, conv3d_cs_direct_launches=direct,
              conv3d_cs_gather_launches=gathered, conv3d_cs_pack_launches=pack,
              deconv2x_cs_launches=deconv, seconds=sec_s2,
              gvox_per_s=n_vox / sec_s2 / 1e9, peak_gib=peak_s2,
              positives=int(bin_s2.sum()), library_conv=s1_profile["library_conv"]))
    bound = int(MASK_FLIPS * mask_us.size)
    if any(not any(k in name for k in from_mask) for name in differing):
        raise AssertionError(f"stage 1 files differ between the card and the CPU: {differing}")
    if any(v < 0 or v > bound for v in flips.values()):
        raise AssertionError(f"stage 1's mask differs from the CPU's beyond {bound}: {flips}")
    if not (mask_us.any() and masked_ok):
        raise AssertionError("stage 1's masked volume is empty or not raw × mask_us")
    if big_flips > MASK_FLIPS * p_card.size or not np.isfinite(p_card).all():
        raise AssertionError(f"{big_flips} probabilities of the first chunk differ from the CPU")
    if n_batches == 0 or (conv, packed, direct, gathered, pack, deconv) != (
            18 * n_batches, PACKED * n_batches, n_batches, 0, PACKED * n_batches,
            4 * n_batches):
        raise AssertionError(f"stage 2 on stage 1's output: launches {counts} for "
                             f"{n_batches} forward batches")
    if s1_profile["library_conv"] or s1_profile["library_transposed_conv"]:
        raise AssertionError("stage 2 on stage 1's output ran a library convolution")
    if not (np.isfinite(sig_s2).all() and bin_s2.shape == VOLUME
            and not bin_s2[masked == 0].any()):
        raise AssertionError("stage 2's binaries on stage 1's output are wrong")


CC_BRANCHES = {  # count_blobs branch: (FLAGS.LOAD_ALL_RAM, cc_workers)
    "ram_native": (True, 1), "ram_slabs": (True, 4), "out_of_core": (False, 0),
}


def count_blobs_run(blob, post, brain, shape, load_all_ram, workers):
    """One count_blobs call into ``post``: (seconds, CSV bytes, cache file
    names, n, labels)."""
    from delivr_cfos_tpu_torch.config import PipelineConfig
    from delivr_cfos_tpu_torch.pipeline.stage03_count_blobs import count_blobs

    cfg = PipelineConfig.from_dict({
        "postprocessing": {"output_location": post, "cc_workers": workers},
        "FLAGS": {"ABSPATHS": True, "LOAD_ALL_RAM": load_all_ram},
    })
    t0 = time.perf_counter()
    path = count_blobs(cfg, blob, 0, brain, (1, 1, *shape))
    seconds = time.perf_counter() - t0
    with open(path, "rb") as f:
        text = f.read()
    names = sorted(os.listdir(post))
    cache = [x for x in names if x.endswith("-cc3d.npy")]
    if len(cache) != 1:
        raise AssertionError(f"stage 3 left the caches {names}")
    n = int(cache[0].rsplit("-", 2)[-2])
    return seconds, text, names, n, np.load(os.path.join(post, cache[0]), mmap_mode="r")


def stage3_phase(card, bin_mem, bin_stream, dev):
    """Phase 11: stage 3 on the binaries of phases 6 and 10, and the device
    labeler against the host engine."""
    from delivr_cfos_tpu_torch.native.build import native_available
    from delivr_cfos_tpu_torch.ops.connected_components import label_volume_device

    engine = "native" if native_available() else "scipy"
    with tempfile.TemporaryDirectory() as tmp:
        blob = os.path.join(tmp, "blob")
        for brain, vol in (("brain", bin_mem), ("stream", bin_stream)):
            seg = os.path.join(blob, brain, "binary_segmentations")
            os.makedirs(seg)
            np.save(os.path.join(seg, "binaries.npy"), vol)
        runs = {b: count_blobs_run(blob, os.path.join(tmp, b) + os.sep, "brain",
                                   VOLUME, *flags)
                for b, flags in CC_BRANCHES.items()}
        first = runs["ram_native"]
        same = all(r[1] == first[1] and r[2] == first[2] and r[3] == first[3]
                   and np.array_equal(r[4], first[4]) for r in runs.values())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_labels, dev_n, rounds = label_volume_device(bin_mem, dev, return_rounds=True)
        sec_dev = time.perf_counter() - t0
        dev_same = dev_n == first[3] and np.array_equal(dev_labels, first[4])

        sec_st, text_st, _, n_st, _ = count_blobs_run(
            blob, os.path.join(tmp, "stream_ooc") + os.sep, "stream", STREAM_VOLUME,
            *CC_BRANCHES["out_of_core"])
        emit(dict(phase="stage3", card=card, engine=engine, volume=list(VOLUME),
                  positives=int(bin_mem.sum()), n=first[3],
                  csv_rows=first[1].count(b"\n") - 1, csv_bytes=len(first[1]),
                  seconds={b: r[0] for b, r in runs.items()},
                  branches_equal=same, device_seconds=sec_dev, device_rounds=rounds,
                  device_labels_equal=dev_same, stream_volume=list(STREAM_VOLUME),
                  stream_seconds_out_of_core=sec_st, stream_n=n_st,
                  stream_csv_rows=text_st.count(b"\n") - 1))
    if engine != "native":
        raise AssertionError("stage 3 ran the scipy engine: the native library did not build")
    if not same:
        raise AssertionError("stage 3 branches disagree (CSV, caches or labels)")
    if not dev_same:
        raise AssertionError("label_volume_device disagrees with the host engine")
    if first[3] < 2 or n_st < 2:
        raise AssertionError("stage 3 found fewer than two components: no CSV rows")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from delivr_cfos_tpu_torch.engine.sliding_window import (
        auto_batch_size, dense_patch_starts,
    )
    from delivr_cfos_tpu_torch.models.basic_unet import (
        _ADN, BasicUNetConfig, basic_unet_apply, build_model, init_state_dict,
    )
    from delivr_cfos_tpu_torch.models.basic_unet_cs import apply_cs
    from delivr_cfos_tpu_torch.ops import _build
    from delivr_cfos_tpu_torch.ops.conv3d_cs import (
        conv3d_cs, conv3d_cs_direct, conv3d_cs_gather, conv3d_cs_pack, conv3d_cs_packed,
        conv3d_cs_path,
    )
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import deconv2x_cs
    from delivr_cfos_tpu_torch.ops.instance_norm_mish import instance_norm_mish

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
    shapes = conv_shapes(fast_cfg.features, ROI)
    paths = [conv3d_cs_path(c1, c2, w, co) for _, _, c1, c2, co, _, _, w in shapes]
    if paths != ["direct"] + ["packed"] * PACKED:
        raise AssertionError(f"the 18 convs take the paths {paths}: not the first conv "
                             f"direct and {PACKED} packed")
    rows = [check_conv(smi, n, batch, d, h, w, c1, c2, co)
            for n, _, c1, c2, co, d, h, w in shapes]
    _, _, c1, c2, co, d, h, w = shapes[0]
    extra = [
        check_conv(smi, "conv_0.1/no_stats", batch, 96, 96, 64, 32, 0, 32, emit_stats=False),
        check_conv(smi, "down_1.1/in_affine", batch, 48, 48, 32, 32, 0, 32, affine=True),
        # the first conv's kernel before the direct one, timed in the same run
        check_conv(smi, "conv_0.0/gather", batch, d, h, w, c1, c2, co, gather=True),
    ]
    torch.cuda.empty_cache()
    up_shapes = deconv_shapes(fast_cfg.features, ROI)
    deconv_rows = [check_deconv(smi, n, batch, d, h, w, c, o)
                   for n, d, h, w, c, o in up_shapes]
    n1, d1, h1, w1, c1, o1 = up_shapes[-1]
    deconv_extra = [check_deconv(smi, n1, batch, d1, h1, w1, c1, o1, with_bias=True)]
    emit(dict(phase="deconv_sum", card=smi, rows=len(deconv_rows + deconv_extra),
              **{k: sum(r[k] for r in deconv_rows + deconv_extra)
                 for k in ("ms", "call_ms", "bound_ms", "library_ms", "library_call_ms")}))
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
    emit(dict(phase="model", card=smi, windows=int(xw.shape[0]), max_abs_dev=dev_max,
              mean_abs_dev=float((fast - parity).abs().mean()),
              parity_mean_abs=scale - 1e-3, rel_dev=dev_max / scale,
              finite=bool(torch.isfinite(fast).all())))
    if not torch.isfinite(fast).all() or dev_max / scale >= 0.5:
        raise AssertionError("fast forward strays from parity beyond 0.5 × mean |logit|")
    del xw, fast, parity
    torch.cuda.empty_cache()

    # --- 5. stage 1, and stage 2 on its output ------------------------------
    stage1_phase(smi, vol, sd, batch, dev)
    torch.cuda.empty_cache()

    # --- 6. stage 2 through run_inference, and 7. fused parity ---------------
    n_active, n_batches = forward_batches(vol, batch, dev)
    parity_batch = auto_batch_size(ROI, BasicUNetConfig(), vol.nbytes, device=dev)
    _, n_batches_par = forward_batches(vol, parity_batch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        write_brain(tmp, vol)
        conv3d_cs.launches = deconv2x_cs.launches = conv3d_cs_pack.launches = 0
        conv3d_cs_packed.launches = conv3d_cs_direct.launches = conv3d_cs_gather.launches = 0
        sec_fast, peak_fast, bin_fast, sig_fast = stage2(tmp, "fast", sd)
        launches, deconv_launches = conv3d_cs.launches, deconv2x_cs.launches
        pack_launches = conv3d_cs_pack.launches
        packed_launches, direct_launches = conv3d_cs_packed.launches, conv3d_cs_direct.launches
        gather_launches = conv3d_cs_gather.launches
        sec_fast_warm, _, _, _ = stage2(tmp, "fast_warm", sd)
        sec_parity, peak_par, bin_par, sig_par = stage2(tmp, "parity", sd, "parity")

        # where stage 2's device time goes: one more fast run, traced
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            sec_traced, _, _, _ = stage2(tmp, "fast_traced", sd)
        fast_profile = profile_summary(prof, sec_traced)
        emit(dict(fast_profile, card=smi, run="stage2 fast"))
        del prof

        # the fused epilogue's path: counts reset just before, read just after
        instance_norm_mish.launches = conv3d_cs.launches = 0
        sec_fused, peak_fused, bin_fused, sig_fused = stage2(
            tmp, "fused", sd, model_cfg=BasicUNetConfig(fused_in_mish=True))
        fused_launches, fused_conv = instance_norm_mish.launches, conv3d_cs.launches

    flipped = bin_fast != bin_par
    margin = float(np.abs(sig_fast - sig_par).max())
    inside = bool((np.abs(sig_par[flipped] - 0.5) <= margin + 1e-6).all())
    n_vox = int(np.prod(VOLUME))
    emit(dict(phase="stage2", card=smi, volume=list(VOLUME), roi=list(ROI),
              windows=int(len(starts)), active_windows=n_active, batch=batch,
              forward_batches=n_batches, kernel_launches=launches,
              conv3d_cs_packed_launches=packed_launches,
              conv3d_cs_direct_launches=direct_launches,
              conv3d_cs_gather_launches=gather_launches,
              conv3d_cs_pack_launches=pack_launches,
              deconv2x_cs_launches=deconv_launches,
              seconds_fast=sec_fast, seconds_fast_warm=sec_fast_warm,
              gvox_per_s_fast=n_vox / sec_fast_warm / 1e9,
              seconds_parity=sec_parity, gvox_per_s_parity=n_vox / sec_parity / 1e9,
              peak_gib_fast=peak_fast, peak_gib_parity=peak_par,
              binaries_dtype=str(bin_fast.dtype), binaries_shape=list(bin_fast.shape),
              positives_fast=int(bin_fast.sum()), positives_parity=int(bin_par.sum()),
              flipped_voxels=int(flipped.sum()), sigmoid_margin=margin,
              flips_inside_margin=inside))
    if launches != 18 * n_batches or pack_launches != PACKED * n_batches:
        raise AssertionError(f"{launches} conv3d_cs and {pack_launches} conv3d_cs_pack "
                             f"launches for {n_batches} forward batches")
    if (packed_launches, direct_launches, gather_launches) != (PACKED * n_batches,
                                                               n_batches, 0):
        raise AssertionError(f"{packed_launches} packed, {direct_launches} direct and "
                             f"{gather_launches} gather conv launches for {n_batches} "
                             "forward batches")
    if deconv_launches != 4 * n_batches:
        raise AssertionError(
            f"{deconv_launches} deconv2x_cs launches != 4 × {n_batches} batches")
    if fast_profile["gather_kernel"] or not fast_profile["conv3d_cs_direct_launches"]:
        raise AssertionError("the fast stage 2 ran the gather kernel or not the direct one: "
                             f"{fast_profile['gather_kernel']}")
    if fast_profile["library_conv"]:
        raise AssertionError("the fast stage 2 ran a library convolution: "
                             f"{fast_profile['library_conv']}")
    if fast_profile["library_transposed_conv"]:
        raise AssertionError("the fast stage 2 still ran the library's transposed conv: "
                             f"{fast_profile['library_transposed_conv']}")
    if bin_fast.shape != VOLUME or bin_fast.dtype != np.uint8:
        raise AssertionError("binaries.npy has the wrong shape or dtype")
    if not (np.isfinite(sig_fast).all() and inside):
        raise AssertionError("fast binaries flip outside the fast-vs-parity margin")

    band = np.abs(logit_of(sig_par)) <= BAND
    fused_ok = bool((bin_fused[~band] == bin_par[~band]).all())
    emit(dict(phase="fused", card=smi, volume=list(VOLUME), batch=parity_batch,
              forward_batches=n_batches_par, in_mish_launches=fused_launches,
              conv3d_cs_launches=fused_conv, seconds=sec_fused,
              gvox_per_s=n_vox / sec_fused / 1e9, peak_gib=peak_fused,
              voxels_in_band=int(band.sum()),
              differing_voxels=int((bin_fused != bin_par).sum()),
              max_sigmoid_dev=float(np.abs(sig_fused - sig_par).max()),
              equal_outside_band=fused_ok))
    if fused_launches != 18 * n_batches_par or fused_conv:
        raise AssertionError(
            f"fused parity stage 2: {fused_launches} instance_norm_mish launches "
            f"for {n_batches_par} forward batches, {fused_conv} conv3d_cs")
    if not (fused_ok and np.isfinite(sig_fused).all()):
        raise AssertionError("fused binaries differ from parity outside the logit band")
    del sig_fast, bin_par, sig_par, bin_fused, sig_fused

    # --- 8. instance_norm_mish vs plain at the fused forward's shapes -------
    f32_rows = [check_in_mish(smi, n, parity_batch, co, d, h, w, torch.float32)
                for n, _, _, _, co, d, h, w in shapes]
    bf16_rows = [check_in_mish(smi, f"{n}/bf16", batch, co, d, h, w, torch.bfloat16)
                 for n, lvl, _, _, co, d, h, w in (shapes[1], shapes[9])]
    torch.cuda.empty_cache()

    # --- 9. fast fallback: bf16 forward with the fused epilogue -------------
    fz, fy, fx = FALLBACK_WINDOW
    wins = np.stack([vol[z:z + fz, y:y + fy, x:x + fx] for z, y, x in
                     [(0, 0, 0), (40, 60, 100), (90, 130, 200), (92, 140, 324)]])
    xw = torch.from_numpy(wins.astype(np.float32))[..., None].to(dev)
    seen = []  # (shape, dtype) of every epilogue input the forward makes
    hooks = [m.register_forward_pre_hook(
        lambda _, args: seen.append((tuple(args[0].shape), args[0].dtype)))
        for m in model.modules() if isinstance(m, _ADN)]
    instance_norm_mish.launches = conv3d_cs.launches = 0
    with torch.no_grad():
        fb = basic_unet_apply(model, xw, BasicUNetConfig(
            precision="fast", fused_in_mish=True))
        fb_launches = instance_norm_mish.launches
        for h in hooks:
            h.remove()
        parity = model(xw)
    dev_max = float((fb.float() - parity).abs().max())
    scale = float(parity.abs().mean()) + 1e-3
    emit(dict(phase="fallback", card=smi, window=list(FALLBACK_WINDOW), windows=int(xw.shape[0]),
              dtype=str(fb.dtype), in_mish_launches=fb_launches,
              conv3d_cs_launches=conv3d_cs.launches, max_abs_dev=dev_max,
              mean_abs_dev=float((fb.float() - parity).abs().mean()),
              parity_mean_abs=scale - 1e-3, rel_dev=dev_max / scale,
              finite=bool(torch.isfinite(fb.float()).all())))
    if fb.dtype != torch.bfloat16 or fb_launches != 18 or conv3d_cs.launches:
        raise AssertionError("the fallback did not run the bf16 forward on the kernel")
    if not torch.isfinite(fb.float()).all() or dev_max / scale >= 0.5:
        raise AssertionError("fallback forward strays from parity beyond 0.5 × mean |logit|")
    del model, xw, fb, parity, vol
    torch.cuda.empty_cache()

    # the bf16 kernel against its plain version at the shapes the fallback
    # forward just gave it (odd plane sizes: the kernel's scalar tail)
    nw = len(wins)
    fb_shapes = conv_shapes(fast_cfg.features, FALLBACK_WINDOW)
    if seen != [((nw, co, d, h, w), torch.bfloat16) for _, _, _, _, co, d, h, w in fb_shapes]:
        raise AssertionError(f"fallback epilogue shapes {seen} differ from conv_shapes")
    fb_rows = [check_in_mish(smi, f"{n}/fallback_bf16", nw, co, d, h, w, torch.bfloat16)
               for n, _, _, _, co, d, h, w in fb_shapes]
    emit(dict(phase="in_mish_fallback", card=smi, window=list(FALLBACK_WINDOW),
              windows=nw, shapes=len(fb_rows),
              max_ulps=max(r["max_ulps"] for r in fb_rows),
              max_abs_err=max(r["max_abs_err"] for r in fb_rows),
              ms=sum(r["ms"] for r in fb_rows),
              plain_ms=sum(r["plain_ms"] for r in fb_rows),
              library_ms=sum(r["library_ms"] for r in fb_rows),
              bound_ms=sum(r["bound_ms"] for r in fb_rows)))
    torch.cuda.empty_cache()

    # --- 10. out-of-core streaming stage 2 against in device memory ---------
    bin_stream = stream_phase(smi, sd, dev)

    # --- 11. stage 3 on the binaries of phases 6 and 10 ----------------------
    stage3_phase(smi, bin_fast, bin_stream, dev)
    del bin_fast, bin_stream

    packed = [r for r in rows + extra if r["path"] == "packed"]
    prow = [r for r in rows if r["path"] == "packed"]
    first = rows[0]
    by_ops = sum(r["bound_ms"] for r in prow if r["bound_by"] == "operations")
    emit(dict(phase="kernel_sum", card=smi, shapes=len(rows),
              kernel_ms=sum(r["kernel_ms"] for r in rows),
              pack_ms=sum(r["pack_ms"] or 0.0 for r in rows),
              ms=sum(r["ms"] for r in rows),
              bound_ms=sum(r["bound_ms"] for r in rows),
              library_ms=sum(r["library_ms"] for r in rows)))
    emit({"kernels": [{
        "name": "conv3d_cs",
        "route": "cuda",
        "source": "delivr_cfos_tpu_torch/csrc/conv3d_cs.cu",
        "replaces": "delivr_cfos_tpu/ops/pallas/conv3d_cs.py:374",
        "launches": packed_launches,
        "max_abs_err": max(r["max_abs_err"] for r in packed),
        # one forward batch: the sum over its 17 packed conv shapes, the
        # conv kernel alone (the pack is an entry of its own)
        "ms": sum(r["kernel_ms"] for r in prow),
        "plain_ms": sum(r["plain_ms"] for r in prow),
        "bound_ms": sum(r["bound_ms"] for r in prow),
        "bound_by": "operations" if by_ops * 2 >= sum(r["bound_ms"] for r in prow) else "bytes",
        "library_ms": sum(r["library_ms"] for r in prow),
    }, {
        "name": "conv3d_cs_direct",
        "route": "cuda",
        "source": "delivr_cfos_tpu_torch/csrc/conv3d_cs.cu",
        # the TPU kernel at C_in = 1, which JAX pads to 2 and runs at P = 8
        "replaces": "delivr_cfos_tpu/ops/pallas/conv3d_cs.py:374",
        "launches": direct_launches,
        "max_abs_err": first["max_abs_err"],
        # one forward batch: the first conv
        "ms": first["kernel_ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
    }, {
        "name": "conv3d_cs_pack",
        "route": "cuda",
        "source": "delivr_cfos_tpu_torch/csrc/conv3d_cs.cu",
        # the TPU kernel stages its padded input in VMEM; on the card that
        # staging is this pass
        "replaces": "delivr_cfos_tpu/ops/pallas/conv3d_cs.py:374",
        "launches": pack_launches,
        "max_abs_err": max(r["pack_max_abs_err"] for r in packed),
        # one forward batch: the sum over its 17 packed conv shapes
        "ms": sum(r["pack_ms"] for r in rows if r["path"] == "packed"),
        "plain_ms": sum(r["pack_plain_ms"] for r in rows if r["path"] == "packed"),
        "bound_ms": sum(r["pack_bound_ms"] for r in rows if r["path"] == "packed"),
        "bound_by": "bytes",
        "library_ms": sum(r["pack_library_ms"] for r in rows if r["path"] == "packed"),
    }, {
        "name": "instance_norm_mish",
        "route": "cuda",
        "source": "delivr_cfos_tpu_torch/csrc/instance_norm_mish.cu",
        "replaces": "delivr_cfos_tpu/ops/pallas/fused_norm_mish.py:59",
        "launches": fused_launches,
        "max_abs_err": max(r["max_abs_err"] for r in f32_rows + bf16_rows + fb_rows),
        # one parity forward batch: the sum over its 18 epilogue shapes
        "ms": sum(r["ms"] for r in f32_rows),
        "plain_ms": sum(r["plain_ms"] for r in f32_rows),
        "bound_ms": sum(r["bound_ms"] for r in f32_rows),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in f32_rows),
    }, {
        "name": "deconv2x_cs",
        "route": "cuda",
        "source": "delivr_cfos_tpu_torch/csrc/deconv2x_cs.cu",
        "replaces": "scripts/probe_deconv.py:117",
        "launches": deconv_launches,
        "max_abs_err": max(r["max_abs_err"] for r in deconv_rows + deconv_extra),
        # one forward batch: the sum over its 4 UpCat shapes
        "ms": sum(r["ms"] for r in deconv_rows),
        "plain_ms": sum(r["plain_ms"] for r in deconv_rows),
        "bound_ms": sum(r["bound_ms"] for r in deconv_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in deconv_rows)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in deconv_rows),
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
