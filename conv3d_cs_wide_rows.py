#!/usr/bin/env python3
"""The packed conv's wide instance at the level-0 shapes of wide windows, on
one NVIDIA GPU: chip_smoke.py phase wide_path's rows alone.

    python3 conv3d_cs_wide_rows.py [--root DIR]

For the full-width BasicUNet on 2 windows of (16, 16, 1024) and of
(64, 96, 640), whose level-0 planes are too wide for the packed ring, runs
``chip_smoke.wide_rows``: each of the three level-0 convs against its plain
version (within one bf16 ULP, the same bits on a relaunch), the pack and the
conv timed apart (device time), one cuDNN bf16 conv beside them and the
bound, then a "wide_path_sum" line a window; and prints the card's name and
power limit. ``--root`` runs the package of another checkout (a version of
the kernel kept under ``build/``) with this checkout's chip_smoke.py, so
that two versions can be timed in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv3d_cs_wide_rows: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import delivr_cfos_tpu_torch
    from delivr_cfos_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cs.emit(dict(phase="build", package=os.path.dirname(delivr_cfos_tpu_torch.__file__),
                 seconds=_build.build_all()))
    for roi in (cs.WIDE_ROI, cs.WIDE_TIMED_ROI):
        cs.wide_rows(card, roi)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
