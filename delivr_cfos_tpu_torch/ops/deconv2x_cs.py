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
import math
from typing import NamedTuple

import torch

from delivr_cfos_tpu_torch.ops import _build
from delivr_cfos_tpu_torch.utils.device import full_f32

# the widest input the kernel takes. It streams C in chunks of 32, so shared
# memory and registers do not grow with C; a block counts its (M tile, K
# chunk) steps in a 32-bit int, and under MAX_VOXELS there are at most 2^24
# M tiles, so ⌈C/32⌉ stays at most 127
MAX_C = 127 * 32
MAX_VOXELS = 1 << 30  # B·D·H·W stays below it: the kernel's voxel indices are 32-bit
TM = 64  # input voxels per tile: the GEMM's rows
TILE_O = 32  # output channels per tile: 8 phases × 32 = 256 GEMM columns
BLOCKS_PER_SM = 2  # resident blocks an SM (registers and shared memory)


class DeconvPlan(NamedTuple):
    """The grid and the kernel instance of one launch."""

    n_tiles: int  # output-channel tiles: gridDim.x
    m_tiles: int  # 64-voxel tiles over the flattened planes
    m_blocks: int  # gridDim.y: block (nt, mg) walks tiles mg, mg + m_blocks, ...
    vec_in: bool  # 16-byte cp.async staging (H·W % 8 == 0, x 16-byte aligned)
    fast_out: bool  # output runs through shared memory (W even, 64 % W == 0)


def deconv2x_cs_plan(planes: int, h: int, w: int, o: int, *, x_aligned: bool,
                     sms: int) -> DeconvPlan:
    """The fixed rule for the one launch over ``planes`` H×W planes into
    ``o`` ≥ 1 channels: enough blocks for ``BLOCKS_PER_SM`` on each of
    ``sms`` SMs, shared among the output-channel tiles, and never more than
    M tiles. Raises where the planes hold ``MAX_VOXELS`` voxels or more."""
    if planes * h * w >= MAX_VOXELS:
        raise ValueError(f"{planes} planes of {h}×{w} voxels: the kernel takes fewer "
                         f"than 2^30 input voxels a call")
    m_tiles = -(-planes * h * w // TM)
    n_tiles = -(-o // TILE_O)
    m_blocks = max(1, min(m_tiles, BLOCKS_PER_SM * sms // n_tiles, 65535))
    return DeconvPlan(n_tiles, m_tiles, m_blocks, (h * w) % 8 == 0 and x_aligned,
                      w % 2 == 0 and TM % w == 0)


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
    """(C, O, 2, 2, 2) → the kernel's B operand, (C, 8·O) bf16, K-major,
    contiguous and 16-byte aligned: column 8·o + p holds output channel o at
    phase p = 4a + 2β + γ, the weight tensor's own order. So an aligned
    contiguous bf16 tensor is taken as it is and an f32 one costs one cast,
    on every call; the kernel zero-fills the last channel tile past O."""
    c, o = weights.shape[:2]
    w_k = weights.to(torch.bfloat16).reshape(c, 8 * o).contiguous()
    return w_k if w_k.data_ptr() % 16 == 0 else w_k.clone()


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
    shape = (b_, 2 * n_d, o, 4 * s)
    if math.prod(shape) == 0:
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)
    plan = deconv2x_cs_plan(b_ * n_d, h, w, o, x_aligned=x.data_ptr() % 16 == 0,
                            sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    w_k = kernel_weights(weights)
    out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    lib = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.deconv2x_cs_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_k.data_ptr()),
            ctypes.c_void_p(bias.data_ptr() if bias is not None else None),
            ctypes.c_void_p(out.data_ptr()), b_ * n_d, c, o, h, w,
            plan.m_blocks, int(plan.vec_in), int(plan.fast_out), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"deconv2x_cs kernel launch failed: CUDA error {err}")
    deconv2x_cs.launches += 1
    return out


deconv2x_cs.launches = 0


def deconv2x_cs_resources(vec_in: bool, fast_out: bool) -> tuple[int, int]:
    """(registers a thread, resident blocks an SM) of the kernel instance
    that (``vec_in``, ``fast_out``) picks, as the card reports them."""
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = _launcher().deconv2x_cs_resources(int(vec_in), int(fast_out), ctypes.byref(regs),
                                            ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"deconv2x_cs_resources failed: CUDA error {err}")
    return regs.value, blocks.value


def _launcher():
    lib = _build.load("deconv2x_cs")
    fn = lib.deconv2x_cs_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.deconv2x_cs_resources.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2)
        lib.deconv2x_cs_resources.restype = ctypes.c_int
    return lib
