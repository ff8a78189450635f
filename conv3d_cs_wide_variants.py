#!/usr/bin/env python3
"""Where the time of the packed conv's wide instance goes, on one NVIDIA GPU.

    python3 conv3d_cs_wide_variants.py

Builds ``delivr_cfos_tpu_torch/csrc/conv3d_cs.cu`` as it is and three
variants, each made by one text substitution that drops one phase of the
packed conv's body: the output stores of the epilogue, the MMA loop of a
stage (its A and B loads and MMAs), and the ``cp.async`` copies that fill a
stage of the wide instance (the ring's waits and barriers stay). Times the wide instance alone
(xp packed and the weights laid out beforehand, device time with the host
queued ahead behind a spin) at the three level-0 convs of the full-width
BasicUNet on 2 windows of (16, 16, 1024) and of (64, 96, 640), each with
and without the stats (without: no partials and no second pass), beside an
``out.fill_`` of the same output and one cuDNN bf16 conv (a yardstick).
Prints one JSON line a shape with the card's name and power limit. The
variants compute wrong outputs: only their times mean anything.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

SPIN_CYCLES = 50_000_000
WINDOWS = 2
# (name, C1, C2, C_out) of the level-0 convs of features (32, 32, 64, 128, 256, 32)
CONVS = (("conv_0.1", 32, 0, 32), ("upcat_1.0", 32, 32, 32), ("upcat_1.1", 32, 0, 32))
ROIS = ((16, 16, 1024), (64, 96, 640))
VARIANTS = {
    "kernel": [],
    "no_stores": [("                  p.out[(((size_t)b * p.D + d) * p.Cout + n) * S + m] =\n"
                   "                      __float2bfloat16(val);",
                   "                  if (val == -1.25e38f) p.out[0] = __float2bfloat16(val);")],
    "no_mma": [("    for (int j = 0; j < 9; ++j) {\n      const int off = (j / 3) * SR",
                "    for (int j = 0; j < 0; ++j) {\n      const int off = (j / 3) * SR")],
    "no_copies": [("        if (r0 + qr < p.H + 2 && x0 + qc < WP) {", "        if (false) {"),
                  ("      cp_async16(w_s + (uint32_t)(row * LDP + q) * 2u,",
                   "      if (false) cp_async16(w_s + (uint32_t)(row * LDP + q) * 2u,")],
}


def device_ms(fn, reps=20):
    """Device time of one call: warm once, queue a spin that outlasts the
    host's enqueueing of ``reps`` calls, then the mean by CUDA events."""
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


def build(tmp):
    """One shared library per variant, all nvcc runs started together."""
    from delivr_cfos_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "conv3d_cs.cu")) as f:
        src = f.read()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"variant {name}: {old!r} is not in conv3d_cs.cu")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.conv3d_cs_packed_wide_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("conv3d_cs_wide_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from delivr_cfos_tpu_torch.ops.conv3d_cs import (
        block_weights, conv3d_cs_pack, kernel_weights, wide_tile_groups,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for roi in ROIS:
            for name, c1, c2, co in CONVS:
                d, h, w = roi
                cin = c1 + c2
                g = torch.Generator(device=dev).manual_seed(0)
                x = torch.randn((WINDOWS, d, c1, h * w), generator=g, device=dev).to(
                    torch.bfloat16)
                x2 = (torch.randn((WINDOWS, d, c2, h * w), generator=g, device=dev).to(
                    torch.bfloat16) if c2 else None)
                wt = torch.randn((3, 3, 3, cin, co), generator=g, device=dev) / math.sqrt(27 * cin)
                xp = conv3d_cs_pack(x, h=h, w=w, x2=x2)
                w_blk = block_weights(kernel_weights(wt, padded=True))
                planes = WINDOWS * d
                per, groups = wide_tile_groups(h, w, planes, co, cin, sms)
                out = torch.empty((WINDOWS, d, co, h * w), dtype=torch.bfloat16, device=dev)
                stats = torch.empty((WINDOWS, d, 2, co), dtype=torch.float32, device=dev)
                partials = torch.empty((planes, groups, 2, co), dtype=torch.float32,
                                       device=dev)
                stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
                ptr = [ctypes.c_void_p(t.data_ptr()) for t in (xp, w_blk)]
                ints = (WINDOWS, d, cin, co, h, w, per)

                def launch(lib, with_stats):
                    st = [ctypes.c_void_p(t.data_ptr() if with_stats else None)
                          for t in (stats, partials)]
                    err = lib.conv3d_cs_packed_wide_launch(
                        *ptr, ctypes.c_void_p(None), ctypes.c_void_p(out.data_ptr()), *st,
                        *ints, stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")

                flops = 2.0 * 27 * cin * co * planes * h * w
                row = dict(card=card, case=f"{name}@{w}", roi=list(roi), windows=WINDOWS,
                           c_in=cin, c_out=co, tiles_per_block=per, groups=groups,
                           bound_ms=1e3 * flops / 989e12)
                for _ in range(2):  # variants in turn, twice
                    for v, lib in libs.items():
                        for with_stats in (True, False):
                            key = f"{v}_ms" if with_stats else f"{v}_no_stats_ms"
                            t = device_ms(lambda: launch(lib, with_stats))
                            row[key] = min(row.get(key, t), t)
                row["fill_ms"] = device_ms(lambda: out.fill_(1.0))
                xin = x if x2 is None else torch.cat([x, x2], dim=2)
                x5 = xin.reshape(WINDOWS, d, cin, h, w).permute(0, 2, 1, 3, 4).contiguous()
                w5 = wt.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()
                row["cudnn_ms"] = device_ms(
                    lambda: torch.nn.functional.conv3d(x5, w5, padding=1))
                print(json.dumps(row), flush=True)
                del x, x2, xp, out, partials, x5, xin
                torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
