#!/usr/bin/env python3
"""Where the narrow conv kernel's time goes, on one NVIDIA GPU.

    python3 conv3d_cs_narrow_variants.py

Builds ``delivr_cfos_tpu_torch/csrc/conv3d_cs.cu`` as it is and three
variants, each made by one text substitution that drops one phase of
``conv3d_cs_narrow_kernel``: the output stores, the MMA k-loop (its A loads,
B loads and MMAs), and the staging of the input planes. Times the kernel
alone (weights laid out beforehand, device time with the host queued ahead
behind a spin) at three shapes: the packed first conv (8 × (96, 96, 64),
C 2 → 64), G = 4's (4 × (96, 96, 64), C 4 → 128) and the first conv's
(128 × (96, 96, 64), C 1 → 32), each with and without stats, beside an
``out.fill_`` of the same output (the card's write rate on these bytes) and
one cuDNN bf16 conv (a yardstick). Prints one JSON line per shape, with the
card's name and power limit. The variants compute wrong outputs: only their
times mean anything.
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
SHAPES = (("packed/conv_0.0", 8, 2, 64), ("g4/conv_0.0", 4, 4, 128),
          ("conv_0.0", 128, 1, 32))
D, H, W = 96, 96, 64
VARIANTS = {
    "kernel": [],
    "no_stores": [("if (col < ncol && m0 + c8 < V) {", "if (col < 0) {"),
                  ("if (m0 + lane < V) o_item", "if (false) o_item")],
    "no_mma": [("for (int s = 0; s < kp / 16; ++s) {", "for (int s = 0; s < 0; ++s) {")],
    "no_staging": [("for (int u = tid; u < units; u += NARROW_THREADS) {",
                    "for (int u = tid; u < 0; u += NARROW_THREADS) {")],
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
        lib.conv3d_cs_narrow_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("conv3d_cs_narrow_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from delivr_cfos_tpu_torch.ops.conv3d_cs import narrow_band_rows, narrow_weights

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for name, b, c, co in SHAPES:
            g = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn((b, D, c, H * W), generator=g, device=dev).to(torch.bfloat16)
            wt = torch.randn((3, 3, 3, c, co), generator=g, device=dev) / math.sqrt(27 * c)
            w_n = narrow_weights(wt)
            out = torch.empty((b, D, co, H * W), dtype=torch.bfloat16, device=dev)
            stats = torch.empty((b, D, 2, co), dtype=torch.float32, device=dev)
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            ints = (b, D, c, 0, co, H, W, narrow_band_rows(c, H, W))
            ptr = [ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(None)
                   for t in (x, None, None, w_n, None, None, None, out)]

            def launch(lib, st):
                err = lib.conv3d_cs_narrow_launch(
                    *ptr, ctypes.c_void_p(st.data_ptr() if st is not None else None),
                    *ints, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            row = dict(card=card, case=name, b=b, c_in=c, c_out=co,
                       bound_ms=1e3 * (2.0 * b * D * H * W * (c + co) + 2.0 * 27 * c * co
                                       + 8.0 * b * D * co) / 3.35e12)
            for _ in range(2):  # variants in turn, twice
                for v, lib in libs.items():
                    for with_stats in (True, False):
                        key = f"{v}_ms" if with_stats else f"{v}_no_stats_ms"
                        t = device_ms(lambda: launch(lib, stats if with_stats else None))
                        row[key] = min(row.get(key, t), t)
            row["fill_ms"] = device_ms(lambda: out.fill_(1.0))
            x5 = x.reshape(b, D, c, H, W).permute(0, 2, 1, 3, 4).contiguous()
            w5 = wt.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()
            row["cudnn_ms"] = device_ms(lambda: torch.nn.functional.conv3d(x5, w5, padding=1))
            print(json.dumps(row), flush=True)
            del x, out, stats, x5
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
