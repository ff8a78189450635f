"""CLI entry point: ``python -m delivr_cfos_tpu_torch [config.json]``.

The counterpart of ``python -m delivr_cfos_tpu`` and of the reference's
``python __main__.py <config>`` (reference: __main__.py:48-67): the same
single positional config argument, default and warning, and the same HOOK
protocol on stdout. The pipeline runs on the card; ``--device cpu`` puts it
on the CPU (the JAX CLI's counterpart is ``JAX_PLATFORMS=cpu``).
"""

from __future__ import annotations

import argparse

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.pipeline.runner import run_pipeline


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="DELIVR inference pipeline (GPU)")
    parser.add_argument(
        "config",
        metavar="config",
        type=str,
        nargs="*",
        default="config.json",
        help="Path to the config file (default ./config.json)",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)",
    )
    args = parser.parse_args(argv)
    config_location = args.config
    if config_location == "config.json":
        print(
            "Warning: using internal default config. If you tried using your "
            "own, please double-check the path!"
        )
    if isinstance(config_location, list):
        config_location = config_location[0]
    print(f"Loading {config_location}")
    cfg = PipelineConfig.from_json(config_location)
    run_pipeline(cfg, device=args.device)


if __name__ == "__main__":
    main()
