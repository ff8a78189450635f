"""PyTorch + CUDA port of delivr_cfos_tpu for NVIDIA Hopper (H100).

The JAX package ``delivr_cfos_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. Ported so far: stage 1, downsample and
mask (``pipeline/stage01_downsample_mask.py::downsample_mask``), in plain
torch; stage 2, blob detection
(``pipeline/stage02_inference.py::run_inference``), with the fast forward in
the hand-written CUDA kernels ``csrc/conv3d_cs.cu`` (every 3×3×3
convolution) and ``csrc/deconv2x_cs.cu`` (the UpCat deconvs), and the fused
InstanceNorm+mish kernel ``csrc/instance_norm_mish.cu``; stage 3, the
per-cell table (``pipeline/stage03_count_blobs.py::count_blobs``).
"""
