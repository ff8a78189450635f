"""``correct`` at a size a test run holds: a sound run of each cell passes;
the control (the reference with float8 operands in the program's place)
and each fault that a cell can have, planted under the timed path, fail.

The cells are cut to TINY widths on a (128, 64, 48) volume (tiny.py) and
run on the CPU, where the program takes its kernels' plain versions, with
the harness's look for a card skipped. The limits here are the tiny cell's
own, set as the full cells' were: between the largest that sound runs of
the program read over a dozen seeds and the smallest the control read
(CPU, tiny sizes; PERF.md gives the readings).
"""

import json
import os

import numpy as np
import pytest
import torch

from tiny import tiny_root

from benchlib import cells, harness

# Limits of the tiny cells, from benchmark/calibrate.py's readings() on the
# CPU at these sizes, seeds 1-12 (stream_brain) and 1-8 (stream_section):
# sound runs of the program read flip_margin up to 0.0367 and 0.0106, the
# float8 control at least 0.182 and 0.0734 where any voxel flips (seeds 8
# and 12 flip none on either side at 4 output channels). flip_share does not
# separate at these sizes (0.0051 against 0.0023; 0.0010 against 0.0005), so
# its tiny limit only sits above the sound runs.
TINY_LIMITS = {
    "delivr_unet.stream_brain": {"outside_mask": 0, "flip_margin": 0.09, "flip_share": 0.008},
    "delivr_unet_tta.stream_section": {"outside_mask": 0, "flip_margin": 0.03,
                                       "flip_share": 0.002},
}
WORKLOADS = sorted(TINY_LIMITS)
SEED = 3  # flips voxels on both sides in both tiny cells


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(tmp_path, workload):
    root = tiny_root(tmp_path, workload)
    spec = cells.benchmark_spec(root)
    w = next(w for w in spec["workloads"] if w["name"] == workload)
    path = os.path.join(root, next(c["file"] for c in spec["configs"] if c["name"] == w["config"]))
    with open(path) as f:
        cfg = json.load(f)
    cfg["limits"] = TINY_LIMITS[workload]
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, cells.find_cell(workload, root)


def run(root, cell):
    return harness.run_cell(cell, SEED, 0, False, "cpu", 0.0, root=root)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload, tmp_path):
    root, cell = tiny_cell(tmp_path, workload)
    r = run(root, cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["flip_share"]["value"] > 0  # the seed puts voxels near the cut


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, tmp_path, monkeypatch):
    root, cell = tiny_cell(tmp_path, workload)
    program = harness.run_brain

    def control(cell, inputs, out_dir, device, brain="brain"):
        if brain != "brain":
            return program(cell, inputs, out_dir, device, brain)
        ref = harness.reference_of(cell, inputs, device, root, quant=cell.config["control"])
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "binaries.npy")
        np.save(path, ref["binary"].to(torch.uint8).numpy())
        return path

    monkeypatch.setattr(harness, "run_brain", control)
    r = run(root, cell)
    assert not r["correct"], r["checks"]


def _unchanged(streaming, sliding_window):
    def accumulate(*args, **kwargs):
        return None  # the slab's accumulators come back as they went in
    return "_accumulate", accumulate


def _half_left_out(streaming, sliding_window):
    orig = streaming._accumulate

    def accumulate(model, vol, u16, acc, cnt, dims, interval, gens, cfg, batch, model_cfg,
                   imp, active_mask=None, win_perm=None):
        # every second active window leaves the batch; the mean is over the rest
        roi = tuple(cfg.roi)
        starts = sliding_window._grid_starts(dims)
        mask = sliding_window._active_mask(vol, u16, starts, roi, cfg.background_threshold)
        dropped = np.nonzero(mask)[0][1::2]
        keep = mask.copy()
        keep[dropped] = False
        orig(model, vol, u16, acc, cnt, dims, interval, gens, cfg, batch, model_cfg, imp,
             active_mask=keep, win_perm=win_perm)
        n = len(sliding_window._tta_passes(cfg))
        for s in starts[dropped]:
            sliding_window._window(acc, s, roi).sub_(sliding_window.SKIP_LOGIT * n)
            sliding_window._window(cnt, s, roi).sub_(n)
    return "_accumulate", accumulate


def _altered(streaming, sliding_window):
    orig = streaming._ChunkWriter.submit

    def submit(self, pairs, lo, hi, next_slab, finalized):
        if pairs:
            dst, t = pairs[0]
            t = t.clone()
            z, y, x = t.shape
            t[z // 2, y // 2 - 4:y // 2 + 4, x // 2 - 4:x // 2 + 4] ^= 1
            pairs = [(dst, t), *pairs[1:]]
        return orig(self, pairs, lo, hi, next_slab, finalized)
    return None, submit


FAULTS = {"state_unchanged": _unchanged, "half_batch_left_out": _half_left_out,
          "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault, tmp_path, monkeypatch):
    from delivr_cfos_tpu_torch.engine import sliding_window, streaming

    root, cell = tiny_cell(tmp_path, workload)
    name, fn = FAULTS[fault](streaming, sliding_window)
    if name is None:
        monkeypatch.setattr(streaming._ChunkWriter, "submit", fn)
    else:
        monkeypatch.setattr(streaming, name, fn)
    r = run(root, cell)
    assert not r["correct"], r["checks"]
