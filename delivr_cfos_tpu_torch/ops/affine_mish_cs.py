"""The fast forward's epilogue: bf16(mish(x·a + c)) over (B, D, C, H·W).

``affine_mish_cs`` launches the hand-written CUDA kernel
``csrc/affine_mish_cs.cu`` (the counterpart of the XLA fusion of
``delivr_cfos_tpu/models/basic_unet_cs.py:108``, ``_affine_mish_cs``) on a
CUDA tensor and runs ``affine_mish_cs_reference``, its plain PyTorch
version, on a CPU tensor. Every other device raises.

Contract: ``a`` and ``c`` are the per-(B, C) factors of an InstanceNorm
folded into one affine (``models/basic_unet_cs.py::_in_affine_from_stats``);
v = x·a + c in f32, rounded after the multiply and after the add, then
v·tanh(softplus(v)) (softplus taken as v above 20) rounded once to bf16. The
kernel's mish is a fast one-exponential form: its bf16 outputs are within one
bf16 ULP of the plain version's.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.ops import _build


def affine_mish_cs_reference(x, a, c):
    """bf16(mish(x·a + c)) per (B, C), computed in f32 in place (two
    full-size f32 temporaries at most)."""
    v = x.float().mul_(a[:, None, :, None]).add_(c[:, None, :, None])
    return v.mul_(F.softplus(v).tanh_()).to(torch.bfloat16)


def _checked(x, a, c):
    """Raise on what the kernel does not take: ``x`` (B, D, C, S) bf16
    contiguous, ``a`` and ``c`` (B, C) f32 contiguous on ``x``'s device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"affine_mish_cs runs on CUDA or the CPU, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, D, C, H·W), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x has dtype {x.dtype}, expected bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, _, ch, _ = x.shape
    for name, t in (("a", a), ("c", c)):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (b, ch):
            raise ValueError(
                f"{name} must be ({b}, {ch}) float32 on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def affine_mish_cs(x, a, c):
    """``x``: (B, D, C, H·W) bf16, contiguous; ``a``, ``c``: (B, C) f32.
    Returns a new bf16 tensor of ``x``'s shape."""
    _checked(x, a, c)
    if x.device.type == "cpu":
        return affine_mish_cs_reference(x, a, c)
    _, d, ch, s = x.shape
    n = x.numel()
    if n == 0:
        return torch.empty_like(x)
    if s >= 2**31 or x.shape[0] * d * ch >= 2**31:
        raise ValueError(f"x of shape {tuple(x.shape)}: S and B·D·C must be below 2^31")
    # out shares x's alignment modulo 16 bytes, so both are read and written
    # as vectors at the same offsets after the kernel's scalar head
    lag = x.data_ptr() % 16 // 2  # elements past x's last 16-byte boundary
    if lag:
        buf = torch.empty(n + 8, dtype=x.dtype, device=x.device)
        shift = (lag - buf.data_ptr() % 16 // 2) % 8
        out = buf[shift:shift + n].view(x.shape)
    else:
        out = torch.empty_like(x)
    head = (8 - lag) % 8  # elements before x's first 16-byte boundary
    lib = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.affine_mish_cs_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p(c.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n, d, ch, s, head, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"affine_mish_cs kernel launch failed: CUDA error {err}")
    affine_mish_cs.launches += 1
    return out


affine_mish_cs.launches = 0


def _launcher():
    lib = _build.load("affine_mish_cs")
    fn = lib.affine_mish_cs_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
