"""InstanceNorm (affine, biased variance) + mish over (N, C, D, H, W).

``instance_norm_mish`` launches the hand-written CUDA kernel
``csrc/instance_norm_mish.cu`` (the counterpart of the TPU kernel
``delivr_cfos_tpu/ops/pallas/fused_norm_mish.py:59``) on a CUDA tensor and
runs ``instance_norm_mish_reference``, its plain PyTorch version, on a CPU
tensor. Every other device raises.

Contract, as on the TPU: per (n, c) plane Σx and Σx² in f32, mean = Σx/S,
var = Σx²/S − mean² (E[x²] − mean², not the two-pass variance; clamped at 0,
so a one-voxel plane gives 0), y = (x − mean)·rsqrt(var + 1e-5)·scale + bias,
then y·tanh(softplus(y)) in f32, rounded once to x's dtype (f32 or bf16).
"""

from __future__ import annotations

import ctypes

import torch

from delivr_cfos_tpu_torch.ops import _build

IN_EPS = 1e-5  # torch InstanceNorm3d default


def instance_norm_mish_reference(x, scale, bias):
    """Plain PyTorch version of the kernel's formula, in f32 with one
    rounding at the end."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, c, -1)
    s = xf.shape[2]
    mean = xf.sum(dim=2, keepdim=True) / s
    var = torch.clamp((xf * xf).sum(dim=2, keepdim=True) / s - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + IN_EPS)
    y = y * scale.float()[None, :, None] + bias.float()[None, :, None]
    softplus = torch.clamp(y, min=0.0) + torch.log1p(torch.exp(-y.abs()))
    return (y * torch.tanh(softplus)).to(x.dtype).reshape(x.shape)


def instance_norm_mish(x, scale, bias):
    """``x``: (N, C, D, H, W) f32 or bf16, contiguous; ``scale``, ``bias``:
    (C,) f32. Returns the same shape and dtype as ``x``."""
    if x.device.type == "cpu":
        return instance_norm_mish_reference(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_mish runs on CUDA or the CPU, not {x.device}")
    if x.dim() != 5:
        raise ValueError(f"x must be (N, C, D, H, W), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, c = x.shape[:2]
    s = x[0, 0].numel()
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(
                f"{name} must be ({c},) float32 on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.instance_norm_mish_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
            ctypes.c_void_p(bias.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n, c, s, int(x.dtype == torch.bfloat16),
            int((x.data_ptr() - out.data_ptr()) % 16 == 0),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"instance_norm_mish kernel launch failed: CUDA error {err}")
    instance_norm_mish.launches += 1
    return out


instance_norm_mish.launches = 0


def _launcher():
    lib = _build.load("instance_norm_mish")
    fn = lib.instance_norm_mish_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
