#!/usr/bin/env python3
"""The spread of chip_smoke.py phase ``train`` part (d)'s fast-vs-parity
margin, on one NVIDIA GPU.

    python3 nifti_margin_runs.py [--runs N] [--root DIR]

Part (d) infers stage 2 on a seeded (192, 480, 384) NIfTI volume with 300
blobs, with weights that part (c) trains by bench.py's recipe (150 Adam
steps at lr 1e-2 of four 32³ crops). cuDNN's backward is not deterministic,
so the weights, and the fast forward's distance from parity, differ from run
to run. This script repeats (c)'s training and (d)'s inference ``N`` times
(default 5) from the same seed and prints, one JSON line a run, what
``chip_smoke.nifti_fast_parity`` measures: the sigmoid margin max |σ(fast) −
σ(parity)|, the voxels that flip, stage-3 cells and blob centres found by
both; then a summary line with the largest margin and the card's name and
power limit. ``--root`` runs the package of another checkout (a parent
commit unpacked with ``git archive``) with this checkout's chip_smoke.py.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nifti_margin_runs: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import delivr_cfos_tpu_torch
    from delivr_cfos_tpu_torch.ops import _build
    from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference_from_nifti
    from delivr_cfos_tpu_torch.training.train import TrainConfig, export_npz, make_train_step
    from delivr_cfos_tpu_torch.utils.io.nifti import write_nifti

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    package = os.path.dirname(os.path.abspath(delivr_cfos_tpu_torch.__file__))
    cs.emit(dict(phase="build", package=package, seconds=_build.build_all()))
    dev = torch.device("cuda")
    margins = []
    with tempfile.TemporaryDirectory() as tmp:
        nii = os.path.join(tmp, "brain.nii")
        for run in range(args.runs):
            t0 = time.perf_counter()
            rng = np.random.default_rng(cs.SEED)  # as train_phase draws: the volume, then (c)
            vol, centres = cs.blob_volume(cs.VOLUME, cs.NIFTI_BLOBS, rng, np.uint16)
            if run == 0:
                write_nifti(nii, np.transpose(vol, (1, 2, 0)))  # (z, y, x) → (y, x, z)
            data = os.path.join(tmp, f"data{run}")
            cs.write_training_patches(data, rng)
            batches = cs.recipe_batches(data, cs.TRAIN_RECIPE["steps"])
            init_state, step = make_train_step(TrainConfig(learning_rate=cs.TRAIN_RECIPE["lr"]))
            model, optimizer = init_state()
            losses = [float(step(model, optimizer, x, y)) for x, y in batches]
            weights = export_npz(model, os.path.join(tmp, f"trained{run}.npz"))
            del model, optimizer, batches
            bins = run_inference_from_nifti(nii, weights, "", window=cs.ROI)
            row = cs.nifti_fast_parity(dev, weights, vol, centres, bins)
            margins.append(row["sigmoid_margin"])
            cs.emit(dict(phase="nifti_margin", card=card, run=run, loss_first=losses[0],
                         loss_last=losses[-1], seconds=time.perf_counter() - t0, **row))
            del bins, vol
            torch.cuda.empty_cache()
    cs.emit(dict(phase="nifti_margin_summary", card=card, package=package, runs=args.runs,
                 margins=margins, largest=max(margins)))
    print(card, flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
