"""A tiny copy of a cell for CPU tests: the benchmark's files under a
temporary root, the cell's configuration and traffic cut to sizes that a
test run holds (the widths and window of its model module's ``TINY``, a
(128, 64, 48) volume in two slabs)."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, REPO_ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import cells  # noqa: E402

TINY_VOLUME = [128, 64, 48]


def tiny_root(tmp, workload: str) -> str:
    """A root under ``tmp`` that holds ``BENCHMARK.json`` and the
    benchmark's files, with ``workload``'s configuration and traffic cut to
    the tiny sizes. Returns its path."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO_ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    w = next(w for w in spec["workloads"] if w["name"] == workload)
    cfg_file = os.path.join(root, next(c["file"] for c in spec["configs"]
                                        if c["name"] == w["config"]))
    with open(cfg_file) as f:
        cfg = json.load(f)
    cfg.update(cells.model_module(cfg, root).TINY, erosion_iters=3, plane_yx=TINY_VOLUME[1:])
    with open(cfg_file, "w") as f:
        json.dump(cfg, f)
    tr_file = os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json")
    with open(tr_file) as f:
        tr = json.load(f)
    tr.update(volume_zyx=TINY_VOLUME, brain_zyx=TINY_VOLUME, offset_zyx=[0, 0, 0])
    tr["texture"]["coarse_step"] = 8
    tr["nuclei"]["per_mvox_tissue"] = 500
    with open(tr_file, "w") as f:
        json.dump(tr, f)
    return root
