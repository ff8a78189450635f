"""Cells by name: ``BENCHMARK.json`` names each cell's configuration and
traffic mix, and the harness finds their files, the per-layer metrics'
readers, and the model and reference modules that a configuration names,
by those names alone, so a later cell, mix, metric, model or reference is a
new file and a new entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration and traffic read
    from their files, and the per-layer metrics that list it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = REPO_ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, root: str = REPO_ROOT) -> Cell:
    """The cell named ``workload``, its configuration from the file its
    ``configs`` entry names and its traffic from ``benchmark/traffic/``,
    whose volume lies on the configuration's plane. The configuration names
    its model module under ``model``."""
    spec = benchmark_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    if "model" not in config:
        raise ValueError(f"{workload}: the configuration {w['config']!r} names no model "
                         "(a module of benchmark/models/)")
    traffic = load_json(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    if list(traffic["volume_zyx"][1:]) != list(config["plane_yx"]):
        raise ValueError(f"{workload}: the traffic's plane {traffic['volume_zyx'][1:]} is not "
                         f"the configuration's plane_yx {config['plane_yx']}")
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=tuple(m for m in spec["end_to_end"] if _applies(m, workload)),
        per_layer=tuple(m for m in spec["per_layer"] if _applies(m, workload)),
    )


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric: str, root: str = REPO_ROOT):
    """The reader module of one per-layer metric,
    ``benchmark/metrics/<metric>.py``: ``LAYER``, ``UNIT``, ``MOVES`` and
    ``read(record)``, which returns the value or None where the record
    holds nothing to read."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    return _load_module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def reference_module(config: dict, root: str = REPO_ROOT):
    """The plain reference that the configuration names,
    ``benchmark/reference/<name>.py``."""
    name = config["reference"]
    path = os.path.join(root, "benchmark", "reference", f"{name}.py")
    return _load_module(path, "bench_reference_" + name)


def model_module(config: dict, root: str = REPO_ROOT):
    """The model module that the configuration names,
    ``benchmark/models/<model>.py``: ``state_shapes``, ``forward_flops``,
    ``conv3d_cs_shapes`` and ``TINY``, each read from the configuration
    (``benchmark/models/basic_unet.py`` states them)."""
    name = config["model"]
    path = os.path.join(root, "benchmark", "models", f"{name}.py")
    return _load_module(path, "bench_model_" + name)
