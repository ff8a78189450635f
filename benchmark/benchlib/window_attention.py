"""Operations, bytes and least times of the window attention kernel: the
yardstick of ``kernels.window_attention_roofline``.

The work is counted from a model's attention shapes (a model module's
``window_attention_shapes``: windows a sample with padding, heads and tokens
a window, for each attention call of one window's forward) and the windows
the inputs need, never from kernel launches. The peaks are ``arith.py``'s.
"""

from __future__ import annotations

from benchlib.arith import PEAK_BF16_FLOPS, PEAK_BYTES

HEAD_DIM = 16


def attention_ops_bytes(windows, heads, n, head_dim=HEAD_DIM):
    """Operations and least bytes of one attention call over ``windows``
    windows of ``n`` tokens and ``heads`` heads: QKᵀ and PV, 2·n²·head_dim
    each a window and head; q, k and v read once and the output written
    once, in bf16. The relative-position bias is counted apart
    (``bias_bytes``)."""
    flops = 4.0 * windows * heads * n * n * head_dim
    nbytes = 2.0 * windows * n * heads * head_dim * 4
    return flops, nbytes


def bias_bytes(heads, n):
    """The f32 (heads, n, n) bias table of one attention call, read once."""
    return 4.0 * heads * n * n


def attention_bound_s(shapes, forwards: float, bias_reads: int = 1) -> float:
    """The least time of the attention calls ``shapes`` ((stage, windows a
    sample, heads, tokens, shifted) of one window's forward) over
    ``forwards`` window forwards, each call's bias table read
    ``bias_reads`` times in all: per call the larger of its operations at
    the bf16 peak and its bytes at the HBM peak."""
    total = 0.0
    for _, windows, heads, n, _ in shapes:
        flops, nbytes = attention_ops_bytes(windows * forwards, heads, n)
        nbytes += bias_reads * bias_bytes(heads, n)
        total += max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    return total


def window_heads(shapes) -> int:
    """Window-heads of one window's forward: Σ windows × heads."""
    return sum(windows * heads for _, windows, heads, _, _ in shapes)
