"""SwinUNETR's window attention op, ``ops/window_attention_cs.py``.

On the CPU (tier 1): the wrapper runs the plain version, which is held to
the plain math written out here (MONAI's attention over explicit windows,
its ``compute_mask`` for the shift mask) within f32 summation order, at the
shapes of every stage of the full-width model at a (96, 96, 64) window: 343
tokens shifted and unshifted, and the 144-token window of the bottom stage.
The padded keys take part. The wrapper refuses what the kernel does not
take.

On the card (marker ``cuda``; skips without one): the CUDA kernel against the
plain version at the same shapes, within bf16 rounding: both sum the same
f32 products in their own orders and round once. This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_window_attention_cs.py
"""

import itertools

import pytest
import torch

from delivr_cfos_tpu_torch.ops.window_attention_cs import (
    kernel_bias,
    regions,
    window_attention_cs,
    window_attention_cs_reference,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (heads, ws, padded, shift, samples) at SwinUNETR's stages on a (96, 96, 64)
# window: stage 1's tokens (48, 48, 32) pad to (49, 49, 35); stage 2's
# (24, 24, 16) to (28, 28, 21); stage 3's (12, 12, 8) to (14, 14, 14); stage
# 4's (6, 6, 4) are one unshifted 144-token window. The CPU cases cut the
# samples and, where the windows are many, the grid.
STAGES = {
    "stage1": (3, (7, 7, 7), (49, 49, 35), (0, 0, 0)),
    "stage1_shifted": (3, (7, 7, 7), (49, 49, 35), (3, 3, 3)),
    "stage2_shifted": (6, (7, 7, 7), (28, 28, 21), (3, 3, 3)),
    "stage3_shifted": (12, (7, 7, 7), (14, 14, 14), (3, 3, 3)),
    "stage4": (24, (6, 6, 4), (6, 6, 4), (0, 0, 0)),
    "partial_shift": (2, (7, 4, 4), (14, 4, 4), (3, 0, 0)),
}
CPU_PADDED = {"stage1": (14, 7, 14), "stage1_shifted": (14, 14, 7),
              "stage2_shifted": (14, 14, 7)}


def _inputs(heads, ws, padded, samples, seed):
    n = ws[0] * ws[1] * ws[2]
    nw = 1
    for p, w in zip(padded, ws):
        nw *= p // w
    g = torch.Generator().manual_seed(seed)
    qkv = (torch.randn((samples * nw, n, 3 * heads * 16), generator=g) * 2).to(torch.bfloat16)
    bias = torch.randn((heads, n, n), generator=g)
    return qkv, bias


def compute_mask(padded, ws, shift):
    """MONAI's ``compute_mask`` as written there: (nW, n, n)."""
    img = torch.zeros((1, *padded, 1))
    cnt = 0
    for d, h, w in itertools.product(*[(slice(-a), slice(-a, -s), slice(-s, None))
                                       for a, s in zip(ws, shift)]):
        img[:, d, h, w, :] = cnt
        cnt += 1
    x = img.view(1, padded[0] // ws[0], ws[0], padded[1] // ws[1], ws[1],
                 padded[2] // ws[2], ws[2], 1)
    win = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2])
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def plain(qkv, bias_hij, heads, ws, padded, shift):
    """MONAI's WindowAttention after the qkv Linear, in f32."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    qkv = qkv.float().reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1) + bias_hij[None]
    if any(shift):
        mask = compute_mask(padded, ws, shift)
        nw = mask.shape[0]
        attn = (attn.view(bw // nw, nw, heads, n, n) + mask[None, :, None]).view(bw, heads, n, n)
    return (attn.softmax(-1) @ v).transpose(1, 2).reshape(bw, n, c)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_cpu_takes_the_plain_version_and_it_is_the_plain_math(stage):
    heads, ws, padded, shift = STAGES[stage]
    padded = CPU_PADDED.get(stage, padded)
    qkv, bias = _inputs(heads, ws, padded, 2, seed=len(stage))
    before = window_attention_cs.launches
    got = window_attention_cs(qkv, kernel_bias(bias), heads=heads, ws=ws, padded=padded,
                              shift=shift)
    assert window_attention_cs.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == (qkv.shape[0], qkv.shape[1],
                                                         heads * 16)
    want = plain(qkv, bias, heads, ws, padded, shift)
    # the same f32 products summed in two orders, then one bf16 rounding:
    # at most one bf16 ULP (2^-8 of the value) apart, plus f32 noise near 0
    err = (got.float() - want).abs()
    assert bool((err <= want.abs() * 2.0**-8 + 1e-5).all()), float(err.max())


@pytest.mark.parametrize("shift", [(3, 3, 3), (3, 0, 0), (0, 3, 3)])
def test_regions_give_monais_mask(shift):
    ws, padded = (7, 7, 7), (14, 21, 14)
    r = regions(ws, padded, shift, "cpu")
    mask = torch.where(r[:, :, None] != r[:, None, :], -100.0, 0.0)
    assert torch.equal(mask, compute_mask(padded, ws, shift))


def test_padded_keys_take_part():
    """Keys of padded tokens (the qkv bias) are attended like any other:
    leaving the last window's padded keys out changes its queries."""
    heads, ws, padded, shift = 1, (7, 7, 7), (7, 7, 7), (0, 0, 0)
    qkv, bias = _inputs(heads, ws, padded, 1, seed=3)
    got = window_attention_cs(qkv, kernel_bias(bias), heads=heads, ws=ws, padded=padded,
                              shift=shift)
    keep = torch.zeros(343, dtype=torch.bool)
    keep[:300] = True  # as if the last 43 tokens were padding, left out
    cut = plain(qkv[:, keep], bias[:, keep][:, :, keep], heads, (1, 1, 300), (1, 1, 300),
                shift)
    assert (got[:, keep].float() - cut).abs().max() > 1e-2


@pytest.mark.parametrize("case", ["qkv_f32", "columns", "tokens", "bias_shape", "bias_f16",
                                  "padded", "samples"])
def test_window_attention_cs_rejects_what_the_kernel_does_not_take(case):
    heads, ws, padded, shift = 2, (7, 4, 4), (14, 4, 4), (3, 0, 0)
    qkv, bias = _inputs(heads, ws, padded, 2, seed=1)
    bias = kernel_bias(bias)
    if case == "qkv_f32":
        qkv = qkv.float()
    elif case == "columns":
        qkv = qkv[:, :, :-16].contiguous()
    elif case == "tokens":
        qkv = qkv[:, :-1].contiguous()
    elif case == "bias_shape":
        bias = bias[:1].contiguous()
    elif case == "bias_f16":
        bias = bias.half()
    elif case == "padded":
        padded = (15, 4, 4)
    elif case == "samples":
        qkv = qkv[:-1].contiguous()
    with pytest.raises(ValueError):
        window_attention_cs(qkv, bias, heads=heads, ws=ws, padded=padded, shift=shift)


# --- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_window_attention_cs_kernel_matches_plain_version(dev, stage):
    heads, ws, padded, shift = STAGES[stage]
    qkv, bias = _inputs(heads, ws, padded, 2, seed=len(stage) + 7)
    qkv, bias = qkv.to(dev), kernel_bias(bias).to(dev)
    before = window_attention_cs.launches
    got = window_attention_cs(qkv, bias, heads=heads, ws=ws, padded=padded, shift=shift)
    torch.cuda.synchronize()
    assert window_attention_cs.launches == before + 1
    want = window_attention_cs_reference(qkv, bias, heads=heads, ws=ws, padded=padded,
                                         shift=shift)
    exact = plain(qkv.cpu(), bias.cpu().transpose(1, 2), heads, ws, padded, shift)
    # each side one bf16 rounding of the same f32 sum: within one bf16 ULP
    # of each other and of the f32 value, beside f32 noise near 0
    for t in (got, want):
        err = (t.float().cpu() - exact).abs()
        assert bool((err <= exact.abs() * 2.0**-8 + 1e-4).all()), float(err.max())
    assert float((got.float() - want.float()).abs().max()) <= float(want.float().abs().max()) * 2**-7
