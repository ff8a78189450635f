"""2×2×2 stride-2 transposed convolution on (B, D, C, H·W) bf16 activations.

``deconv2x_cs`` launches the hand-written CUDA kernel ``csrc/deconv2x_cs.cu``
(the counterpart of the TPU kernel ``scripts/probe_deconv.py:117``
``_variant_d``, the in-kernel form of the fast forward's UpCat deconv
``delivr_cfos_tpu/models/basic_unet_cs.py::_deconv2x_cs``) on a CUDA tensor
and runs ``deconv2x_cs_reference``, its plain PyTorch version, on a CPU
tensor. Every other device raises.

Contract, as on the TPU: weights in ConvTranspose3d layout (C, O, 2, 2, 2)
rounded to bf16; phase a reads kernel index a directly (no flip); f32
accumulation; an optional (O,) bias added in f32; one round-to-nearest-even
to bf16; the output (B, 2D, O, 4·H·W) written in that order:
out[b, 2d+a, o, (2y+β)·2W + 2x+γ] = bf16(Σ_c x[b, d, c, y·W+x]·w[c, o, a, β, γ]
+ bias[o]).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.ops import _build
from delivr_cfos_tpu_torch.utils.device import full_f32

# the kernel stages a block's weights and input tile, (C rounded up to 16)
# × 208 bf16, beside a 34 KiB f32 tile, in at most 227 KiB of shared memory
MAX_C = 464


def deconv2x_cs_reference(x, weights, bias=None, *, h, w):
    """Plain PyTorch version: inputs and weights rounded to bf16, an f32
    einsum over C without TF32, the bias added in f32, one rounding."""
    b_, d, c, s = x.shape
    o = weights.shape[1]
    xf = x.to(torch.bfloat16).float().reshape(b_, d, c, h, w)
    wf = weights.to(torch.bfloat16).float()
    with full_f32():
        # (b, d, a, o, y, β, x, γ): (d, a) and (y, β, x, γ) merge into the
        # output's 2D and (2H)·(2W) axes
        y = torch.einsum("bdcyx,coapq->bdaoypxq", xf, wf)
    if bias is not None:
        y = y + bias.float()[None, None, None, :, None, None, None, None]
    return y.to(torch.bfloat16).reshape(b_, 2 * d, o, 4 * s)


def kernel_weights(weights):
    """(C, O, 2, 2, 2) → the kernel's layout, (⌈O/16⌉, C, 8, 16) bf16: phase
    4a + 2β + γ before O, O zero-padded to a multiple of 16 and cut into
    tiles of 16 channels, one block's weights contiguous."""
    c, o = weights.shape[:2]
    tiles = -(-o // 16)
    w8 = weights.to(torch.bfloat16).permute(0, 2, 3, 4, 1).reshape(c, 8, o)
    w8 = F.pad(w8, (0, 16 * tiles - o))
    return w8.reshape(c, 8, tiles, 16).permute(2, 0, 1, 3).contiguous()


def deconv2x_cs(x, weights, bias=None, *, h, w):
    """``x``: (B, D, C, H·W) bf16, contiguous; ``weights``: (C, O, 2, 2, 2)
    (any float dtype, rounded to bf16); ``bias``: (O,) f32 or None.
    Returns (B, 2D, O, 4·H·W) bf16."""
    if x.device.type == "cpu":
        return deconv2x_cs_reference(x, weights, bias, h=h, w=w)
    if x.device.type != "cuda":
        raise ValueError(f"deconv2x_cs runs on CUDA or the CPU, not {x.device}")
    dev = x.device
    if x.dim() != 4:
        raise ValueError(f"x must be (B, D, C, H·W), got shape {tuple(x.shape)}")
    b_, n_d, c, s = x.shape
    if s != h * w:
        raise ValueError(f"plane size {s} != h·w = {h}·{w}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x has dtype {x.dtype}, expected bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if c > MAX_C:
        raise ValueError(f"{c} input channels exceed the kernel's {MAX_C}")
    o = weights.shape[1] if weights.dim() == 5 else -1
    if weights.device != dev or tuple(weights.shape) != (c, o, 2, 2, 2):
        raise ValueError(
            f"weights must be ({c}, O, 2, 2, 2) on {dev}, got "
            f"{tuple(weights.shape)} on {weights.device}"
        )
    if bias is not None and (
        bias.device != dev or bias.dtype != torch.float32
        or tuple(bias.shape) != (o,) or not bias.is_contiguous()
    ):
        raise ValueError(
            f"bias must be contiguous ({o},) float32 on {dev}, got "
            f"{tuple(bias.shape)} {bias.dtype} on {bias.device}"
        )
    w_k = kernel_weights(weights)
    out = torch.empty((b_, 2 * n_d, o, 4 * s), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    lib = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.deconv2x_cs_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_k.data_ptr()),
            ctypes.c_void_p(bias.data_ptr() if bias is not None else None),
            ctypes.c_void_p(out.data_ptr()), b_, n_d, c, o, h, w,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"deconv2x_cs kernel launch failed: CUDA error {err}")
    deconv2x_cs.launches += 1
    return out


deconv2x_cs.launches = 0


def _launcher():
    lib = _build.load("deconv2x_cs")
    fn = lib.deconv2x_cs_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
