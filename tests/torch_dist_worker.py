"""One rank of a multi-process run of the port's runner, for
``torch.multiprocessing.spawn`` (a module of its own: the spawned children
import it, and it imports neither JAX nor the JAX package)."""

import contextlib
import os


def run_rank(rank: int, raw_cfg: dict, port: int, log_dir: str) -> None:
    """Join a two-process gloo group through ``DELIVR_COORDINATOR`` and run
    the pipeline on the CPU, this rank's log in ``log_dir/rank{rank}.log``."""
    import torch
    import torch.distributed as dist

    from delivr_cfos_tpu_torch.config import PipelineConfig
    from delivr_cfos_tpu_torch.pipeline.runner import run_pipeline

    torch.set_num_threads(1)
    os.environ.update(DELIVR_COORDINATOR=f"127.0.0.1:{port}", DELIVR_NUM_PROCESSES="2",
                      DELIVR_PROCESS_ID=str(rank))
    with open(os.path.join(log_dir, f"rank{rank}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        try:
            run_pipeline(PipelineConfig.from_dict(raw_cfg), device="cpu", devices=["cpu"])
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
