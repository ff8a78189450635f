#!/usr/bin/env python3
"""Hashes of conv3d_cs's outputs at the 18 conv shapes of the production
forward, on one NVIDIA GPU: the check that a change to the conv kernels
leaves the production shapes' bits as they were.

    python3 conv3d_cs_hashes.py [--root DIR] [--out FILE] [--compare FILE]

For each shape of the full-width BasicUNet (features (32, 32, 64, 128, 256,
32), window (96, 96, 64)) at WINDOWS windows: seeded bf16 inputs on the card
(pair mode with its bias at the UpCat convs), then conv3d_cs with the stats
and without, and conv3d_cs_pack on the packed path; prints one JSON line
with the path, the packed instance and the sha256 of each output's bytes,
and the card's name and power limit. ``--root`` imports the package of
another checkout (a parent commit unpacked with ``git archive``); ``--out``
writes the hashes to FILE; ``--compare`` holds them to FILE's and exits 1
on any difference.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import zlib

import torch

FEATURES = (32, 32, 64, 128, 256, 32)
ROI = (96, 96, 64)
WINDOWS = 4


def conv_shapes():
    """(name, C1, C2, C_out, D, H, W) of the 18 convs of one forward."""
    f = FEATURES
    rows = [("conv_0.0", 0, 1, 0, f[0]), ("conv_0.1", 0, f[0], 0, f[0])]
    for i in range(1, 5):
        rows += [(f"down_{i}.0", i, f[i - 1], 0, f[i]), (f"down_{i}.1", i, f[i], 0, f[i])]
    for i, (skip, up, out) in zip((4, 3, 2, 1), ((f[3], f[3], f[3]), (f[2], f[2], f[2]),
                                                  (f[1], f[1], f[1]), (f[0], f[1], f[5]))):
        rows += [(f"upcat_{i}.0", i - 1, skip, up, out), (f"upcat_{i}.1", i - 1, out, 0, out)]
    return [(n, c1, c2, co, ROI[0] >> lvl, ROI[1] >> lvl, ROI[2] >> lvl)
            for n, lvl, c1, c2, co in rows]


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--out")
    ap.add_argument("--compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv3d_cs_hashes: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import delivr_cfos_tpu_torch.ops.conv3d_cs as ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    hashes = {}
    for name, c1, c2, cout, d, h, w in conv_shapes():
        g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
        cin = c1 + c2
        x = torch.randn((WINDOWS, d, c1, h * w), generator=g, device=dev).to(torch.bfloat16)
        wt = torch.randn((3, 3, 3, c1, cout), generator=g, device=dev) / math.sqrt(27 * cin)
        bias = torch.randn((cout,), generator=g, device=dev) * 0.1
        pair = None
        if c2:
            pair = (torch.randn((WINDOWS, d, c2, h * w), generator=g, device=dev).to(torch.bfloat16),
                    torch.randn((3, 3, 3, c2, cout), generator=g, device=dev) / math.sqrt(27 * cin),
                    torch.randn((c2,), generator=g, device=dev) * 0.1)
        out, st = ops.conv3d_cs(x, wt, bias, h=h, w=w, emit_stats=True, pair=pair)
        plain = ops.conv3d_cs(x, wt, None, h=h, w=w, pair=pair)
        path = ops.conv3d_cs_path(c1, c2, w, cout)
        row = dict(path=path, out=digest(out), stats=digest(st), out_no_stats=digest(plain))
        if path == "packed":
            row["instance"] = "wide" if getattr(ops, "packed_wide", lambda _: False)(w) else "ring"
            row["pack"] = digest(ops.conv3d_cs_pack(
                x, h=h, w=w, x2=None if pair is None else pair[0],
                bias2=None if pair is None else pair[2]))
        hashes[name] = row
    torch.cuda.synchronize()
    line = dict(phase="conv3d_cs_hashes", card=card, root=os.path.abspath(args.root),
                windows=WINDOWS, hashes=hashes)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hashes, f)
    ok = True
    if args.compare:
        with open(args.compare) as f:
            other = json.load(f)
        differ = sorted(n for n in hashes if hashes[n] != other.get(n))
        line.update(compared_with=args.compare, shapes=len(hashes), differing=differ)
        ok = not differ and set(other) == set(hashes)
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
