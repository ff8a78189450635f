"""One run of one cell: set-up, the measured window, the reference check and
the result line.

The window drives the program's stage-2 entry,
``delivr_cfos_tpu_torch.pipeline.stage02_inference.run_inference``, over the
cell's phantom, streamed from stage 1's memmap, one brain after another (a
closed loop, as the runner takes brains). It closes at the end of the first
brain that ends after ``seconds``. Every brain writes its own
``binaries.npy``; once the window has closed and the program's state is
freed, the plain reference decides each of them.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext

import numpy as np
import torch

from benchlib import cells
from benchlib.compare import NUMBERS, compare, within, worst
from benchlib.phantom import active_windows, make_phantom, sub_seeds, write_stage1
from benchlib.trace import (
    VOLUME_SPAN,
    WINDOW_SPAN,
    collect,
    device_ops,
    idle_gaps,
    program_kernel_names,
    union_seconds,
)
from benchlib.weights import make_weights

PROGRAM = "delivr_cfos_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "delivr_cfos_tpu")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name, compared whole,
    is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def pipeline_config(cell: cells.Cell, in_dir: str, out_dir: str):
    """The program's stage-2 configuration for the cell's settings."""
    from delivr_cfos_tpu_torch.config import PipelineConfig

    c, t = cell.config, cell.traffic
    return PipelineConfig.from_dict({
        "blob_detection": {
            "input_location": in_dir,
            "output_location": out_dir,
            "window_dimensions": dict(zip(
                ("window_dim_0", "window_dim_1", "window_dim_2"), c["window_zyx"])),
            "precision": c["precision"],
            "importance": c["importance"],
            "erosion_iters": c["erosion_iters"],
        },
        "FLAGS": {
            "ABSPATHS": True,
            "TEST_TIME_AUGMENTATION": c["tta"],
            "SAVE_ACTIVATED_OUTPUT": t["input"]["SAVE_ACTIVATED_OUTPUT"],
            "LOAD_ALL_RAM": t["input"]["LOAD_ALL_RAM"],
        },
    })


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Inputs:
    """What set-up makes from the seed: the weights on the device, the
    phantom written as stage 1's output under ``in_dir`` (brain "brain"),
    and a warm-up brain ("warm") of the traffic's ``warm_rows`` window rows
    from its middle, with their active windows; ``phases``: seconds by
    step."""

    sd: dict
    in_dir: str
    phantom_path: str
    n_active: int
    n_windows: int
    n_warm_active: int
    phases: dict


def _phase(phases: dict, name: str, device, t: float) -> float:
    """Record the seconds since ``t`` under ``name``, once the device is
    idle; returns the new mark."""
    _sync(device)
    now = time.perf_counter()
    phases[name] = now - t
    return now


def make_inputs(cell: cells.Cell, seed: int, device, work: str) -> Inputs:
    cfg, traffic = cell.config, cell.traffic
    roi = tuple(cfg["window_zyx"])
    shape = tuple(traffic["volume_zyx"])
    device = torch.device(device)
    phases = {}
    t = time.perf_counter()
    s_weights, s_phantom = sub_seeds(seed, 2)
    sd = make_weights(cfg, s_weights, device)
    t = _phase(phases, "weights", device, t)
    vol = make_phantom(traffic, s_phantom, device)
    t = _phase(phases, "phantom", device, t)
    n_active, n_windows = active_windows(vol, roi, cfg["overlap"], cfg["background_threshold"])
    z_stride = int(roi[0] * (1 - cfg["overlap"])) or 1
    warm_planes = min(shape[0], (int(traffic["warm_rows"]) - 1) * z_stride + roi[0])
    z0 = (shape[0] - warm_planes) // 2
    warm = vol[z0:z0 + warm_planes]
    n_warm, _ = active_windows(warm, roi, cfg["overlap"], cfg["background_threshold"])
    t = _phase(phases, "count", device, t)
    in_dir = os.path.join(work, "in")
    phantom_path = write_stage1(vol, in_dir)
    write_stage1(warm, in_dir, brain="warm")
    _phase(phases, "write", device, t)
    return Inputs(sd, in_dir, phantom_path, n_active, n_windows, n_warm, phases)


def run_brain(cell: cells.Cell, inputs: Inputs, out_dir: str, device,
              brain: str = "brain") -> str:
    """One call of the program's stage-2 entry over ``brain``; returns the
    path of the binaries it wrote."""
    from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference

    shape = np.load(os.path.join(inputs.in_dir, brain, "masked_niftis", "masked_nifti.npy"),
                    mmap_mode="r").shape
    session = run_inference(pipeline_config(cell, inputs.in_dir, out_dir), brain, shape,
                            params=inputs.sd, device=device)
    _sync(device)
    return os.path.join(session, "binary_segmentations", "binaries.npy")


def reference_of(cell: cells.Cell, inputs: Inputs, device, root: str = cells.REPO_ROOT,
                 quant=None) -> dict:
    """The plain reference's decision over the phantom, from the file that
    the program read and the weights that it was given (windows in batches
    of 8, which the f32 activations of the full widths fit beside)."""
    ref_mod = cells.reference_module(cell.config, root)
    vol = np.load(inputs.phantom_path, mmap_mode="r")[0, 0].astype(np.int32)
    return ref_mod.reference(torch.from_numpy(vol).to(device), inputs.sd, cell.config,
                             quant=quant, batch=8)


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: str = cells.REPO_ROOT) -> dict:
    """One run of ``cell``; returns the result line's object. ``t_start``:
    the perf_counter reading at which set-up began."""
    program = _package_dir()
    device = torch.device(device)
    cfg = cell.config
    shape = tuple(cell.traffic["volume_zyx"])
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
    t = _phase(phases, "context", device, t)
    import delivr_cfos_tpu_torch.pipeline.stage02_inference  # noqa: F401

    t = _phase(phases, "program", device, t)
    if device.type == "cuda":
        from delivr_cfos_tpu_torch.ops import _build

        _build.build_all()
    _phase(phases, "kernels", device, t)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = tempfile.mkdtemp(prefix="delivr_bench_", dir=base)
    try:
        inputs = make_inputs(cell, seed, device, work)
        free_device(device)
        # warm-up: the cell's settings over the middle window rows of the
        # phantom, at least one full batch of windows; it loads the kernels
        # and touches every op and batch shape of the path
        t = time.perf_counter()
        run_brain(cell, inputs, os.path.join(work, "warm"), device, brain="warm")
        phases.update(inputs.phases)
        _phase(phases, "warm", device, t)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
            + f"); {inputs.n_active} of {inputs.n_windows} windows active, "
            f"{inputs.n_warm_active} in the warm-up")

        # the measured window
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        outputs = []
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN) if trace else nullcontext():
            while True:
                tv = time.perf_counter()
                with torch.profiler.record_function(VOLUME_SPAN) if trace else nullcontext():
                    out_dir = os.path.join(work, "out", f"v{len(outputs)}")
                    outputs.append(run_brain(cell, inputs, out_dir, device))
                now = time.perf_counter()
                log(f"volume {len(outputs) - 1}: {now - tv:.3f} s")
                if now - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        trace_rec = None
        if prof is not None:
            t_trace = time.perf_counter()
            prof.__exit__(None, None, None)
            trace_rec = collect(prof)
            del prof
            log(f"trace read in {time.perf_counter() - t_trace:.3f} s")
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(f"loaded after the window: {', '.join(found)}")

        # the reference, once the program's state is freed
        free_device(device)
        t_ref = time.perf_counter()
        ref = reference_of(cell, inputs, device, root)
        readings = [compare(np.load(p, mmap_mode="r"), ref) for p in outputs]
        log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    limits = {k: float(cfg["limits"][k]) for k in NUMBERS}
    numbers = worst(readings)
    failed = sum(not within(r, limits) for r in readings)
    volumes = len(outputs)
    passes = 13 if cfg["tta"] else 1  # 1 base + 4 × (noise, z-flip, y-flip)
    result = {"correct": failed == 0, "attempted": volumes, "failed": failed}
    if trace:
        window_ns = trace_rec["window"][1] - trace_rec["window"][0]
        busy_s = union_seconds(trace_rec) if trace_rec["device"]["start"].size else 0.0
        record = {
            "trace": trace_rec,
            "window_s": window_ns / 1e9,
            "busy_s": busy_s,
            "program_kernels": program_kernel_names(program),
            "config": cfg,
            "volumes": volumes,
            "passes": passes,
            "forwards": inputs.n_active * passes * volumes,
            "peak_bytes": peak,
        }
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"], root).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        voxels = volumes * int(np.prod(shape))
        e2e = {"gvox_per_s": voxels / window_s / 1e9, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    on_card = device.type == "cuda"
    result["device"] = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": cell.chips,
        "memory_peak_bytes": peak,
        "power_limit": power_limit() if on_card else None,
    }
    if trace:
        result["device"].update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = {"device_ops": device_ops(trace_rec),
                               "idle_gaps": idle_gaps(trace_rec)}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return result


def _package_dir() -> str:
    import importlib.util

    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or spec.origin is None:
        raise ModuleNotFoundError(f"{PROGRAM} is not in this checkout")
    return os.path.dirname(os.path.realpath(spec.origin))


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = cells.find_cell(args.workload)
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found {n}")
        return 3
    program = _package_dir()
    if os.path.dirname(program) != os.path.realpath(cells.REPO_ROOT):
        log(f"{PROGRAM} was found at {program}, outside this checkout")
        return 2
    torch.cuda.set_device(0)
    log(f"start: imports {t - t_start:.3f} s, CUDA {time.perf_counter() - t:.3f} s")
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    except ForbiddenImport as e:
        log(str(e))
        return 4
    return emit(result)


def emit(result: dict) -> int:
    """Print the result line, unless JAX or the JAX package has been loaded
    by now: the reference and the metric readers run after the window's
    own check."""
    found = forbidden_modules()
    if found:
        log(f"loaded before the result: {', '.join(found)}")
        return 4
    for k, v in result["checks"].items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
