"""The readings that a cell's limits are set from, on the card, in one
process: for each seed the program's stage 2 over the cell's phantom judged
by the float32 reference (the lower readings), and for the control seeds
the reference computed with float8 operands put in the program's place
(the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out results.jsonl]

Prints one JSON line a seed and side; the benchmark's runs do not run this.
"""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
sys.path[:0] = [BENCH_DIR, ROOT]

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchlib import cells, harness  # noqa: E402
from benchlib.compare import compare  # noqa: E402


def readings(cell, seeds, control_seeds, device, emit) -> None:
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    warm = False
    for seed in seeds:
        work = tempfile.mkdtemp(prefix="delivr_calib_", dir=base)
        try:
            inputs = harness.make_inputs(cell, seed, device, work)
            harness.free_device(device)
            if not warm:
                harness.run_brain(cell, inputs, os.path.join(work, "warm"), device, brain="warm")
                warm = True
            t = time.perf_counter()
            out = harness.run_brain(cell, inputs, os.path.join(work, "out"), device)
            program_s = time.perf_counter() - t
            harness.free_device(device)
            t = time.perf_counter()
            ref = harness.reference_of(cell, inputs, device)
            ref_s = time.perf_counter() - t
            emit({"workload": cell.name, "seed": seed, "side": "program",
                  **compare(np.load(out, mmap_mode="r"), ref),
                  "program_s": program_s, "reference_s": ref_s})
            if seed in control_seeds:
                t = time.perf_counter()
                ctl = harness.reference_of(cell, inputs, device, quant=cell.config["control"])
                ctl_s = time.perf_counter() - t
                got = ctl["binary"].to(torch.uint8).cpu().numpy()
                del ctl
                emit({"workload": cell.name, "seed": seed, "side": "control",
                      "precision": cell.config["control"], **compare(got, ref),
                      "control_s": ctl_s})
            del ref
            harness.free_device(device)
        finally:
            shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    cell = cells.find_cell(args.workload)
    device = torch.device("cuda:0")
    from delivr_cfos_tpu_torch.ops import _build

    _build.build_all()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, seeds, control, device, emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
