"""The fast forwards' epilogue: bf16(act(x·a + c [+ r·a_r + c_r])) over
(B, D, C, H·W).

``affine_act_cs`` launches the hand-written CUDA kernel
``csrc/affine_mish_cs.cu`` (the counterpart of the XLA fusion of
``delivr_cfos_tpu/models/basic_unet_cs.py:108``, ``_affine_mish_cs``) on a
CUDA tensor and runs ``affine_act_cs_reference``, its plain PyTorch
version, on a CPU tensor. Every other device raises. ``affine_mish_cs`` is
its mish instance without a residual, BasicUNet's epilogue, with a launch
count of its own.

Contract: ``a`` and ``c`` are the per-(B, C) factors of an InstanceNorm
folded into one affine (``models/basic_unet_cs.py::_in_affine_from_stats``);
v = x·a + c in f32, rounded after the multiply and after the add, then
v·tanh(softplus(v)) (softplus taken as v above 20) rounded once to bf16. The
kernel's mish is a fast one-exponential form: its bf16 outputs are within one
bf16 ULP of the plain version's.

The activation is mish or LeakyReLU(0.01); the optional residual operand
gives v = (x·a + c) + (r·a_r + c_r), each product and sum rounded in f32 in
that order (SwinUNETR's residual blocks, ``lrelu(IN(conv2) + IN(conv3(x))
or x)``). The LeakyReLU instances equal their plain version to the bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.ops import _build

LRELU_SLOPE = 0.01
ACTS = {"mish": 0, "lrelu": 1}  # the kernel's act_kind


def affine_act_cs_reference(x, a, c, act="lrelu", residual=None):
    """bf16(act(x·a + c [+ r·a_r + c_r])) per (B, C), computed in f32 in
    place (two full-size f32 temporaries at most without the residual)."""
    v = x.float().mul_(a[:, None, :, None]).add_(c[:, None, :, None])
    if residual is not None:
        r, ar, cr = residual
        v.add_(r.float().mul_(ar[:, None, :, None]).add_(cr[:, None, :, None]))
    if act == "lrelu":
        return F.leaky_relu(v, LRELU_SLOPE).to(torch.bfloat16)
    return v.mul_(F.softplus(v).tanh_()).to(torch.bfloat16)


def _checked(x, a, c):
    """Raise on what the kernel does not take: ``x`` (B, D, C, S) bf16
    contiguous, ``a`` and ``c`` (B, C) f32 contiguous on ``x``'s device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"affine_act_cs runs on CUDA or the CPU, not {x.device}")
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


def affine_mish_cs_reference(x, a, c):
    """bf16(mish(x·a + c)) per (B, C): ``affine_mish_cs``'s plain version."""
    return affine_act_cs_reference(x, a, c, act="mish")


def affine_mish_cs(x, a, c):
    """bf16(mish(x·a + c)): ``affine_act_cs``'s mish instance without a
    residual. Its launches are counted apart from the other instances'."""
    before = affine_act_cs.launches
    out = affine_act_cs(x, a, c, act="mish")
    affine_mish_cs.launches += affine_act_cs.launches - before
    return out


affine_mish_cs.launches = 0


def _empty_aligned_like(x, like=None):
    """An empty tensor of ``x``'s shape and dtype whose data pointer shares
    ``like``'s (default ``x``'s) alignment modulo 16 bytes."""
    lag = (x if like is None else like).data_ptr() % 16 // 2  # past the last boundary
    if not lag:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    shift = (lag - buf.data_ptr() % 16 // 2) % 8
    return buf[shift:shift + x.numel()].view(x.shape)


def _aligned_like(t, ref):
    """``t``, or a copy of it, whose data pointer shares ``ref``'s
    alignment modulo 16 bytes."""
    if t.data_ptr() % 16 == ref.data_ptr() % 16:
        return t
    return _empty_aligned_like(t, ref).copy_(t)


def affine_act_cs(x, a, c, act="lrelu", residual=None):
    """``x``: (B, D, C, H·W) bf16, contiguous; ``a``, ``c``: (B, C) f32;
    ``act``: "mish" or "lrelu"; ``residual``: None or (r, a_r, c_r) of the
    shapes of (x, a, c). Returns a new bf16 tensor of ``x``'s shape."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    _checked(x, a, c)
    if residual is not None:
        r, ar, cr = residual
        _checked(r, ar, cr)
        if r.shape != x.shape or r.device != x.device:
            raise ValueError(f"the residual {tuple(r.shape)} on {r.device} is not x's "
                             f"{tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return affine_act_cs_reference(x, a, c, act, residual)
    _, d, ch, s = x.shape
    n = x.numel()
    if n == 0:
        return torch.empty_like(x)
    if s >= 2**31 or x.shape[0] * d * ch >= 2**31:
        raise ValueError(f"x of shape {tuple(x.shape)}: S and B·D·C must be below 2^31")
    # out shares x's alignment modulo 16 bytes, so both are read and written
    # as vectors at the same offsets after the kernel's scalar head
    out = _empty_aligned_like(x)
    rp = arp = crp = None
    if residual is not None:
        r = _aligned_like(residual[0], x)
        rp, arp, crp = r.data_ptr(), residual[1].data_ptr(), residual[2].data_ptr()
    head = (8 - x.data_ptr() % 16 // 2) % 8  # elements before x's first 16-byte boundary
    lib = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.affine_act_cs_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p(c.data_ptr()), ctypes.c_void_p(rp), ctypes.c_void_p(arp),
            ctypes.c_void_p(crp), ctypes.c_void_p(out.data_ptr()),
            n, d, ch, s, head, ACTS[act], ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"affine_act_cs kernel launch failed: CUDA error {err}")
    affine_act_cs.launches += 1
    return out


affine_act_cs.launches = 0


def _launcher():
    lib = _build.load("affine_mish_cs")
    act = lib.affine_act_cs_launch
    if act.argtypes is None:
        act.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 2
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        act.restype = ctypes.c_int
    return lib
