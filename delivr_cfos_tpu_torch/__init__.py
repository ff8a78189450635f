"""PyTorch + CUDA port of delivr_cfos_tpu for NVIDIA Hopper (H100).

The JAX package ``delivr_cfos_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. Ported so far: stage 2, blob detection
(``pipeline/stage02_inference.py::run_inference``), with every 3×3×3
convolution of the fast forward in the hand-written CUDA kernel
``csrc/conv3d_cs.cu``.
"""
