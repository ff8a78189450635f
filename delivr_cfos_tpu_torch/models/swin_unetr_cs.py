"""SwinUNETR fast forward on the port's kernels.

Same math as the parity forward (``models/swin_unetr.py::SwinUNETR``); only
roundings and summation orders differ. bf16 operands with f32 accumulation
(cuBLAS's reduced-precision bf16 reductions are switched off for the call),
f32 statistics:

- encoder: the patch embed, every Linear and the MLP's GELU as PyTorch bf16
  ops; the residual stream, LayerNorms and the hidden states' norms in f32,
  rounded to bf16 where a Linear or a conv block reads them; pad, roll,
  partition and the PatchMerging gather in PyTorch; the window attention on
  ``window_attention_cs`` (scores, softmax and sums in f32 on chip), whose
  relative-position bias is gathered once per window size and kept on the
  attention module;
- conv blocks, in (B, D, C, H·W) layout: every 3×3×3 conv on ``conv3d_cs``
  (the C_in = 1 first conv on its direct path, the up-blocks' first conv in
  pair mode over (upsampled, skip)) with the per-plane (Σx, Σx²) it emits,
  from which each InstanceNorm is one affine per (B, C); every InstanceNorm +
  LeakyReLU, and the block's residual add, on ``affine_act_cs``; the 1×1×1
  residual convs as bf16 matmuls, their InstanceNorm statistics in f32;
- the transposed convs on ``deconv2x_cs``; the 1×1×1 head a bf16 matmul.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.models.swin_unetr import (
    IN_EPS,
    SwinUNETR,
    check_window,
    from_windows,
    merge_gather,
    to_windows,
    window_geometry,
)
from delivr_cfos_tpu_torch.ops.affine_mish_cs import affine_act_cs
from delivr_cfos_tpu_torch.ops.conv3d_cs import conv3d_cs
from delivr_cfos_tpu_torch.ops.deconv2x_cs import deconv2x_cs
from delivr_cfos_tpu_torch.ops.window_attention_cs import kernel_bias, window_attention_cs
from delivr_cfos_tpu_torch.utils.profiling import annotate, count

BF16 = torch.bfloat16
STATS_CHUNK_ELEMS = 2**26  # f32 elements a chunk of the residual's statistics


@contextmanager
def _f32_accumulation():
    """bf16 matmuls that accumulate in f32 throughout."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


def _w(t):
    return None if t is None else t.detach().to(BF16)


def _linear(x, lin):
    return F.linear(x, _w(lin.weight), _w(lin.bias))


def _layer_norm(x, norm=None):
    """f32 LayerNorm over the channels of f32 ``x``."""
    if norm is None:
        return F.layer_norm(x, x.shape[-1:], eps=IN_EPS)
    return F.layer_norm(x, x.shape[-1:], norm.weight.detach(), norm.bias.detach(),
                        eps=norm.eps)


def attention_bias(attn, n: int) -> torch.Tensor:
    """The kernel-layout bias of an n-token window, gathered from the table
    once and kept on the module while the table is unchanged."""
    table = attn.relative_position_bias_table
    key = (n, table.data_ptr(), table._version)
    cache = attn.__dict__.setdefault("_kernel_bias", {})
    if key not in cache:
        cache.clear()
        cache[key] = kernel_bias(attn.bias(n).detach())
    return cache[key]


def _block_cs(x, blk):
    """One Swin block on f32 tokens (B, D, H, W, C)."""
    attn = blk.attn
    geo = window_geometry(x.shape[1:4], attn.window, blk.shifted)
    count("model.window_heads_attended", x.shape[0] * geo.n_windows * attn.heads)
    xw = to_windows(_layer_norm(x, blk.norm1).to(BF16), geo)
    o = window_attention_cs(_linear(xw, attn.qkv), attention_bias(attn, geo.n),
                            heads=attn.heads, ws=geo.ws, padded=geo.padded, shift=geo.shift)
    x = x + from_windows(_linear(o, attn.proj), geo, x.shape[0]).float()
    h = _layer_norm(x, blk.norm2).to(BF16)
    return x + _linear(F.gelu(_linear(h, blk.mlp.linear1)), blk.mlp.linear2).float()


def _cs(t):
    """Channels-last tokens (B, D, H, W, C) → bf16 (B, D, C, H·W)."""
    b, d, h, w, c = t.shape
    return t.to(BF16).permute(0, 1, 4, 2, 3).reshape(b, d, c, h * w).contiguous()


def encoder_cs(vit, x):
    """``x``: bf16 (N, D, H, W, C_in) → the five normalized hidden states in
    (B, D', C', H'·W') bf16."""
    n, d, h, w, cin = x.shape
    p = vit.patch_embed.proj
    k = p.kernel_size[0]
    patches = x.view(n, d // k, k, h // k, k, w // k, k, cin).permute(0, 1, 3, 5, 7, 2, 4, 6)
    patches = patches.reshape(n, d // k, h // k, w // k, cin * k**3)
    x = F.linear(patches, _w(p.weight).reshape(p.out_channels, -1), _w(p.bias)).float()
    hidden = [_cs(_layer_norm(x))]
    for layer in vit.stages():
        for blk in layer.blocks:
            x = _block_cs(x, blk)
        m = layer.downsample
        x = _linear(_layer_norm(merge_gather(x), m.norm).to(BF16), m.reduction).float()
        hidden.append(_cs(_layer_norm(x)))
    return hidden


def _norm_affine(s1, s2, n_vox):
    """Sums (B, C) of x and x² → InstanceNorm as x·a + c (no affine)."""
    mean = s1 / n_vox
    var = torch.clamp(s2 / n_vox - mean * mean, min=0.0)
    a = torch.rsqrt(var + IN_EPS)
    return a, -mean * a


def _conv_norm(st, n_vox):
    s = st.sum(dim=1)  # (B, 2, C) f32 from the conv's per-plane sums
    return _norm_affine(s[:, 0], s[:, 1], n_vox)


def _tensor_norm(r):
    """InstanceNorm factors of bf16 ``r`` (B, D, C, S), sums in f32 over
    chunks of planes."""
    b, d, c, s = r.shape
    step = max(1, STATS_CHUNK_ELEMS // max(1, b * c * s))
    s1 = torch.zeros((b, c), dtype=torch.float32, device=r.device)
    s2 = torch.zeros_like(s1)
    for z in range(0, d, step):
        t = r[:, z:z + step].float()
        s1 += t.sum(dim=(1, 3))
        s2 += t.square_().sum(dim=(1, 3))
    return _norm_affine(s1, s2, d * s)


def _dhwio(conv):
    return conv.weight.detach().permute(2, 3, 4, 1, 0)


def _res_block_cs(xs, blk, h, w):
    """``lrelu(IN(conv2(lrelu(IN(conv1(x))))) + r)`` on x = concat(xs) in
    (B, D, C, H·W) bf16; r = IN(conv3(x)) where the block has conv3, else x."""
    b, d = xs[0].shape[:2]
    n_vox = d * h * w
    w1 = _dhwio(blk.conv1.conv)
    if len(xs) == 2:
        c1 = xs[0].shape[2]
        y, st = conv3d_cs(xs[0], w1[:, :, :, :c1], None, h=h, w=w, emit_stats=True,
                          pair=(xs[1], w1[:, :, :, c1:]))
    else:
        y, st = conv3d_cs(xs[0], w1, None, h=h, w=w, emit_stats=True)
    y = affine_act_cs(y, *_conv_norm(st, n_vox), act="lrelu")
    y, st = conv3d_cs(y, _dhwio(blk.conv2.conv), None, h=h, w=w, emit_stats=True)
    a, c = _conv_norm(st, n_vox)
    if hasattr(blk, "conv3"):
        w3 = _w(blk.conv3.conv.weight)[:, :, 0, 0, 0]  # (C_out, C_in)
        if w3.shape[1] == 1:
            r = xs[0] * w3.view(1, 1, -1, 1)
        else:
            r = torch.matmul(w3, xs[0] if len(xs) == 1 else torch.cat(xs, dim=2))
        a_r, c_r = _tensor_norm(r)
    else:
        r = xs[0]
        a_r = torch.ones_like(a)
        c_r = torch.zeros_like(c)
    return affine_act_cs(y, a, c, act="lrelu", residual=(r, a_r, c_r))


def _up_cs(x, skip, blk, h, w):
    """``h``, ``w``: the skip's plane; the transposed conv without bias,
    then the residual block over (upsampled, skip)."""
    up = deconv2x_cs(x, blk.transp_conv.conv.weight.detach(), None, h=h // 2, w=w // 2)
    return _res_block_cs([up, skip], blk.conv_block, h, w)


@torch.no_grad()
def apply_cs(model: SwinUNETR, x):
    """``x``: (N, D, H, W, C_in) → bf16 logits (N, D, H, W, C_out). Spatial
    dims must divide by 32."""
    check_window(x.shape[1:4])
    n, d, h, w, cin = x.shape
    with _f32_accumulation():
        x = x.to(BF16)
        with annotate("model.swin_encoder"):
            hs = encoder_cs(model.swinViT, x)
        xcs = x.permute(0, 1, 4, 2, 3).reshape(n, d, cin, h * w).contiguous()
        enc0 = _res_block_cs([xcs], model.encoder1.layer, h, w)
        enc1 = _res_block_cs([hs[0]], model.encoder2.layer, h // 2, w // 2)
        enc2 = _res_block_cs([hs[1]], model.encoder3.layer, h // 4, w // 4)
        enc3 = _res_block_cs([hs[2]], model.encoder4.layer, h // 8, w // 8)
        dec4 = _res_block_cs([hs[4]], model.encoder10.layer, h // 32, w // 32)
        dec3 = _up_cs(dec4, hs[3], model.decoder5, h // 16, w // 16)
        dec2 = _up_cs(dec3, enc3, model.decoder4, h // 8, w // 8)
        dec1 = _up_cs(dec2, enc2, model.decoder3, h // 4, w // 4)
        dec0 = _up_cs(dec1, enc1, model.decoder2, h // 2, w // 2)
        out = _up_cs(dec0, enc0, model.decoder1, h, w)
        head = model.out.conv.conv
        logits = torch.matmul(_w(head.weight)[:, :, 0, 0, 0], out)  # (N, D, C_out, S)
        logits = logits + _w(head.bias)[:, None]
    return logits.reshape(n, d, -1, h, w).permute(0, 1, 3, 4, 2)
