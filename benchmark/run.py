"""Run one benchmark cell once on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository; ``BENCHMARK.json`` names
the cells. Exits non-zero without a result where there is no CUDA device,
or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the program's build caches stay in the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
sys.path[:0] = [BENCH_DIR, ROOT]

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
