"""PyTorch + CUDA port of delivr_cfos_tpu for NVIDIA Hopper (H100).

The JAX package ``delivr_cfos_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. All six stages are ported and run in order
through ``pipeline/runner.py::run_pipeline``, behind the CLI
``python -m delivr_cfos_tpu_torch config.json``: stage 1, downsample and
mask (``pipeline/stage01_downsample_mask.py``), in plain torch; stage 2,
blob detection (``pipeline/stage02_inference.py``), with the fast forward in
the hand-written CUDA kernels ``csrc/conv3d_cs.cu`` (every 3×3×3
convolution) and ``csrc/deconv2x_cs.cu`` (the UpCat deconvs), and the fused
InstanceNorm+mish kernel ``csrc/instance_norm_mish.cu``; stage 3, the
per-cell table (``pipeline/stage03_count_blobs.py``); stage 4, atlas
registration and cell warping (``pipeline/stage04_atlas_align.py``); stage
5, region tables and heatmaps (``pipeline/stage05_region_assignment.py``);
stage 6, region-colored and depth-map stacks
(``pipeline/stage06_visualization.py``). Every entry point runs on the card
unless asked for the CPU (``device="cpu"``, ``--device cpu``).
"""
