"""SwinUNETR's shifted-window attention at head dim 16, scores kept on chip.

``window_attention_cs`` launches the hand-written CUDA kernel
``csrc/window_attention_cs.cu`` on a CUDA tensor and runs
``window_attention_cs_reference``, its plain PyTorch version, on a CPU
tensor. Every other device raises.

Contract: ``qkv`` (B·nW, n, 3C) bf16, the qkv Linear's output in window order
(q, k, v of head h at columns h·16, C + h·16, 2C + h·16); ``bias`` (heads, n,
n) f32 key-major, ``bias[h, j, i]`` the relative-position bias of query i
against key j (``kernel_bias`` turns a query-major table round); ``ws``,
``padded``, ``shift`` the windows' geometry per axis (z, y, x). In f32:
s_ij = (q_i · k_j)·scale + bias + mask_ij, with mask −100 between tokens of
different regions of the padded, rolled grid where any shift is set
(MONAI's ``compute_mask``), softmax over j, Σ_j p_ij v_j, one rounding to
bf16: (B·nW, n, C).
"""

from __future__ import annotations

import ctypes

import torch

from delivr_cfos_tpu_torch.ops import _build

HEAD_DIM = 16
MAX_TOKENS = 343
MASK_VALUE = -100.0


def kernel_bias(bias_hij: torch.Tensor) -> torch.Tensor:
    """(heads, n, n) query-major f32 → the kernel's key-major layout."""
    return bias_hij.float().transpose(1, 2).contiguous()


def regions(ws, padded, shift, device) -> torch.Tensor:
    """(nW, n) int64: the region of each token of each window of one
    sample, as the kernel computes it. Per axis of padded size P, window ws
    and shift s > 0: 0 below P − ws, 1 below P − s, 2 from there; one region
    where s is 0."""
    per_axis = []
    for w, p, s in zip(ws, padded, shift):
        pos = torch.arange(p, device=device)
        r = torch.zeros(p, dtype=torch.int64, device=device)
        if s:
            r = (pos >= p - w).long() + (pos >= p - s).long()
        per_axis.append(r.view(p // w, w))
    rz, ry, rx = per_axis
    g = rz[:, None, None, :, None, None] * 9 + ry[None, :, None, None, :, None] * 3 \
        + rx[None, None, :, None, None, :]
    return g.reshape(-1, ws[0] * ws[1] * ws[2])


def window_attention_cs_reference(qkv, bias, *, heads, ws, padded, shift):
    """The plain version: f32 scores, softmax and sums from the bf16
    ``qkv``, the bias and the region mask; bf16 output."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    q, k, v = qkv.float().view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-2, -1)) * (hd ** -0.5) + bias.float().transpose(1, 2)[None]
    if any(shift):
        r = regions(ws, padded, shift, qkv.device)
        nw = r.shape[0]
        mask = torch.where(r[:, :, None] != r[:, None, :], MASK_VALUE, 0.0)
        s = (s.view(bw // nw, nw, heads, n, n) + mask[None, :, None]).view(bw, heads, n, n)
    out = s.softmax(dim=-1) @ v
    return out.transpose(1, 2).reshape(bw, n, c).to(torch.bfloat16)


def _checked(qkv, bias, heads, ws, padded):
    if qkv.device.type not in ("cuda", "cpu"):
        raise ValueError(f"window_attention_cs runs on CUDA or the CPU, not {qkv.device}")
    if qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be (B·nW, n, 3C) contiguous bf16, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    bw, n, c3 = qkv.shape
    if c3 != 3 * heads * HEAD_DIM:
        raise ValueError(f"qkv has {c3} columns; {heads} heads of {HEAD_DIM} need "
                         f"{3 * heads * HEAD_DIM}")
    if n != ws[0] * ws[1] * ws[2] or n > MAX_TOKENS:
        raise ValueError(f"{n} tokens a window for a window of {tuple(ws)} (at most "
                         f"{MAX_TOKENS})")
    if any(p % w for p, w in zip(padded, ws)):
        raise ValueError(f"padded size {tuple(padded)} is not whole windows of {tuple(ws)}")
    nw = (padded[0] // ws[0]) * (padded[1] // ws[1]) * (padded[2] // ws[2])
    if bw % nw:
        raise ValueError(f"{bw} windows are not whole samples of {nw}")
    if (bias.device != qkv.device or bias.dtype != torch.float32
            or tuple(bias.shape) != (heads, n, n) or not bias.is_contiguous()):
        raise ValueError(f"bias must be ({heads}, {n}, {n}) contiguous float32 on "
                         f"{qkv.device}, got {tuple(bias.shape)} {bias.dtype} on {bias.device}")


def window_attention_cs(qkv, bias, *, heads, ws, padded, shift):
    """(B·nW, n, C) bf16 attention output of every window and head."""
    _checked(qkv, bias, heads, ws, padded)
    if qkv.device.type == "cpu":
        return window_attention_cs_reference(qkv, bias, heads=heads, ws=ws, padded=padded,
                                             shift=shift)
    bw, n, c3 = qkv.shape
    out = torch.empty((bw, n, c3 // 3), dtype=torch.bfloat16, device=qkv.device)
    lib = _launcher()
    ints = ctypes.c_int * 3
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.window_attention_cs_launch(
            ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), bw, heads, ints(*ws), ints(*padded),
            ints(*shift), ctypes.c_float(HEAD_DIM ** -0.5), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"window_attention_cs kernel launch failed: CUDA error {err}")
    window_attention_cs.launches += 1
    return out


window_attention_cs.launches = 0


def _launcher():
    lib = _build.load("window_attention_cs")
    fn = lib.window_attention_cs_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
