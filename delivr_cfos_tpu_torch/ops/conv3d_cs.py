"""3×3×3 SAME convolution on (B, D, C, H·W) bf16 activations.

``conv3d_cs`` launches the hand-written CUDA kernel ``csrc/conv3d_cs.cu``
(the counterpart of the TPU kernel ``delivr_cfos_tpu/ops/pallas/
conv3d_cs.py:374``) on a CUDA tensor and runs ``conv3d_cs_reference``, its
plain PyTorch version, on a CPU tensor. Every other device raises.

Contract, as on the TPU: f32 accumulation, bf16 output; optional ``bias``;
``emit_stats`` adds the per-plane (Σx, Σx²) of the f32 output before
rounding, (B, D, 2, C_out) f32; ``pair=(x2, w2[, bias2])`` convolves
concat([x, bf16(x2 + bf16(bias2))]) without building it; ``in_affine=(a, c)``
applies bf16(mish(x·a + c)) to the loaded input. Odd C_in is taken as is.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.ops import _build
from delivr_cfos_tpu_torch.utils.device import full_f32


def _mish(v: torch.Tensor) -> torch.Tensor:
    return v * torch.tanh(F.softplus(v))


def _split_pair(pair):
    if pair is None:
        return None, None, None
    x2, w2 = pair[0], pair[1]
    return x2, w2, (pair[2] if len(pair) > 2 else None)


def conv3d_cs_reference(x, weights, bias, *, h, w, in_affine=None,
                        emit_stats=False, pair=None):
    """Plain PyTorch version of ``conv3d_cs`` with the kernel's roundings:
    inputs and weights rounded to bf16, the pair bias rounded to bf16 and
    added in f32 with one rounding, the affine prologue rounded to bf16, an
    f32 convolution without TF32, stats from the f32 output."""
    if pair is not None and in_affine is not None:
        raise ValueError("pair mode is incompatible with in_affine")
    x2, w2, bias2 = _split_pair(pair)
    xf = x.to(torch.bfloat16).float()
    if x2 is not None:
        x2f = x2.to(torch.bfloat16).float()
        if bias2 is not None:
            b2 = bias2.to(torch.bfloat16).float()[None, None, :, None]
            x2f = (x2f + b2).to(torch.bfloat16).float()
        xf = torch.cat([xf, x2f], dim=2)
        weights = torch.cat([weights, w2], dim=3)
    if in_affine is not None:
        a, c = in_affine
        v = xf * a.float()[:, None, :, None] + c.float()[:, None, :, None]
        xf = _mish(v).to(torch.bfloat16).float()
    b_, d, cin, s = xf.shape
    cout = weights.shape[-1]
    x5 = xf.reshape(b_, d, cin, h, w).permute(0, 2, 1, 3, 4)
    w5 = weights.to(torch.bfloat16).float().permute(4, 3, 0, 1, 2)
    with full_f32():
        y = F.conv3d(x5, w5, padding=1)
    if bias is not None:
        y = y + bias.float()[None, :, None, None, None]
    y = y.permute(0, 2, 1, 3, 4).reshape(b_, d, cout, s)
    out = y.to(torch.bfloat16)
    if not emit_stats:
        return out
    return out, torch.stack([y.sum(dim=3), (y * y).sum(dim=3)], dim=2)


def _check(t, name, dtype, shape, device):
    """Raise unless ``t`` has this device, shape and (when ``dtype`` is not
    None) dtype and is contiguous; weights may be any float view."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dtype is not None and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def conv3d_cs(x, weights, bias, *, h, w, in_affine=None, emit_stats=False,
              pair=None):
    """3×3×3 SAME conv. ``x``: (B, D, C_in, H·W) bf16; ``weights``: DHWIO
    (3, 3, 3, C_in, C_out); ``bias``: (C_out,) or None. Returns (B, D, C_out,
    H·W) bf16, and (B, D, 2, C_out) f32 stats with ``emit_stats``."""
    if x.device.type == "cpu":
        return conv3d_cs_reference(
            x, weights, bias, h=h, w=w, in_affine=in_affine,
            emit_stats=emit_stats, pair=pair,
        )
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_cs runs on CUDA or the CPU, not {x.device}")
    if pair is not None and in_affine is not None:
        raise ValueError("pair mode is incompatible with in_affine")
    dev = x.device
    b_, n_d, c1, s = x.shape
    if s != h * w:
        raise ValueError(f"plane size {s} != h·w = {h}·{w}")
    cout = weights.shape[-1]
    x2, w2, bias2 = _split_pair(pair)
    c2 = 0 if x2 is None else x2.shape[2]
    cin = c1 + c2
    _check(x, "x", torch.bfloat16, (b_, n_d, c1, s), dev)
    _check(weights, "weights", None, (3, 3, 3, c1, cout), dev)
    ws = [weights]
    if x2 is not None:
        _check(x2, "x2", torch.bfloat16, (b_, n_d, c2, s), dev)
        _check(w2, "w2", None, (3, 3, 3, c2, cout), dev)
        ws.append(w2)
    # the kernel's weight layout: DHWIO flattened to (27·C_in, C_out) bf16
    w_k = torch.cat(ws, dim=3).to(torch.bfloat16).reshape(27 * cin, cout).contiguous()
    pb = None
    if bias2 is not None:
        pb = bias2.to(device=dev, dtype=torch.bfloat16).contiguous()
        _check(pb, "bias2", torch.bfloat16, (c2,), dev)
    if bias is not None:
        _check(bias, "bias", torch.float32, (cout,), dev)
    a = c = None
    if in_affine is not None:
        a, c = (t.to(torch.float32).contiguous() for t in in_affine)
        _check(a, "in_affine a", torch.float32, (b_, cin), dev)
        _check(c, "in_affine c", torch.float32, (b_, cin), dev)
    out = torch.empty((b_, n_d, cout, s), dtype=torch.bfloat16, device=dev)
    stats = (
        torch.empty((b_, n_d, 2, cout), dtype=torch.float32, device=dev)
        if emit_stats else None
    )
    lib = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conv3d_cs_launch(
            _ptr(x), _ptr(x2), _ptr(pb), _ptr(w_k), _ptr(bias), _ptr(a),
            _ptr(c), _ptr(out), _ptr(stats),
            b_, n_d, c1, c2, cout, h, w, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"conv3d_cs kernel launch failed: CUDA error {err}")
    conv3d_cs.launches += 1
    return (out, stats) if emit_stats else out


conv3d_cs.launches = 0


def _launcher():
    lib = _build.load("conv3d_cs")
    fn = lib.conv3d_cs_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
