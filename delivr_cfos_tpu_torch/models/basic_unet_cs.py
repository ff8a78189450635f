"""BasicUNet fast forward in (B, D, C, H·W) layout on the conv3d_cs and
deconv2x_cs kernels.

The counterpart of ``delivr_cfos_tpu/models/basic_unet_cs.py::apply_cs``:
bf16 activations, f32 accumulation, and InstanceNorm statistics in f32 from
the per-plane (Σx, Σx²) that every conv emits, so no norm re-reads a conv
output. Same math as the MONAI eval pass (``basic_unet.BasicUNet``); only
roundings and summation orders differ.

Every 3×3×3 conv of the forward, levels 3 and 4 included, runs through
conv3d_cs, each InstanceNorm + mish after it through affine_mish_cs (one
pass, bf16 in and out), and the four UpCat deconvs through deconv2x_cs,
which writes its output in the (B, 2D, O, 4S) layout the next conv reads.
The JAX package sends planes under 256 voxels to XLA instead
(``_PALLAS_MIN_PLANE``); that gate served the TPU's lane layout and has no
counterpart on the card. The difference stays at bf16 rounding level.
"""

from __future__ import annotations

import torch

from delivr_cfos_tpu_torch.models.basic_unet import IN_EPS, BasicUNet
from delivr_cfos_tpu_torch.ops.affine_mish_cs import affine_mish_cs
from delivr_cfos_tpu_torch.ops.conv3d_cs import conv3d_cs
from delivr_cfos_tpu_torch.ops.deconv2x_cs import deconv2x_cs
from delivr_cfos_tpu_torch.utils.device import full_f32


def _dhwio(conv) -> torch.Tensor:
    """OIDHW module weight → DHWIO view (the conv3d_cs weight layout)."""
    return conv.weight.detach().permute(2, 3, 4, 1, 0)


def _in_affine_from_stats(stats, scale, bias, n_vox):
    """Per-plane (Σx, Σx²) → per-(B, C) factors a = inv·scale and
    c = bias − mean·a, so that IN(x)·scale + bias = x·a + c. The variance is
    E[x²] − mean², clamped at 0."""
    s = stats.sum(dim=1)  # (B, 2, C) f32
    mean = s[:, 0] / n_vox
    var = torch.clamp(s[:, 1] / n_vox - mean * mean, min=0.0)
    inv = torch.rsqrt(var + IN_EPS)
    a = inv * scale.detach().float()[None, :]
    c = bias.detach().float()[None, :] - mean * a
    return a, c


def _conv_stats_cs(x, conv, h, wd, pair=None):
    """Kernel conv with stats and no bias: the conv bias cancels exactly
    under the InstanceNorm that follows (IN subtracts the per-(B, C) mean,
    and c = bias_IN − mean·a is the same from biasless statistics).

    ``pair=(x2, bias2)``: pair mode over concat([x, x2 + bias2]); the weight
    splits at ``x``'s channel count."""
    w = _dhwio(conv)
    if pair is None:
        return conv3d_cs(x, w, None, h=h, w=wd, emit_stats=True)
    x2, bias2 = pair
    c1 = x.shape[2]
    return conv3d_cs(
        x, w[:, :, :, :c1], None, h=h, w=wd, emit_stats=True,
        pair=(x2, w[:, :, :, c1:], bias2),
    )


def _two_conv_cs(x, block, h, wd, pair=None):
    """conv → IN → mish → conv → IN → mish, with IN from kernel stats."""
    c0, c1 = block.conv_0, block.conv_1
    n_vox = x.shape[1] * h * wd  # (D, S) per (B, C)
    y0, st0 = _conv_stats_cs(x, c0.conv, h, wd, pair=pair)
    a0, b0 = _in_affine_from_stats(st0, c0.adn.N.weight, c0.adn.N.bias, n_vox)
    y0 = affine_mish_cs(y0, a0, b0)
    y1, st1 = _conv_stats_cs(y0, c1.conv, h, wd)
    a1, b1 = _in_affine_from_stats(st1, c1.adn.N.weight, c1.adn.N.bias, n_vox)
    return affine_mish_cs(y1, a1, b1)


def _maxpool2_cs(x, h, wd):
    """2× max-pool of (B, D, C, S); max is exact, so any formulation is."""
    b, d, c, _ = x.shape
    y = torch.maximum(x[:, 0::2], x[:, 1::2])
    v = y.reshape(b, d // 2, c, h // 2, 2, wd // 2, 2)
    m = v.amax(dim=(4, 6))
    return m.reshape(b, d // 2, c, (h // 2) * (wd // 2)), h // 2, wd // 2


def _upcat_cs(x, x_skip, up, h, wd):
    """``h``, ``wd``: the skip level's plane dims. The deconv runs without
    its bias; the first conv runs in pair mode over (skip, raw deconv
    output) with the deconv bias folded into the loads: no concat and no
    broadcast-add in device memory."""
    x0 = deconv2x_cs(x, up.upsample.deconv.weight.detach(), None, h=h // 2, w=wd // 2)
    return _two_conv_cs(
        x_skip, up.convs, h, wd, pair=(x0, up.upsample.deconv.bias.detach())
    )


@torch.no_grad()
def apply_cs(model: BasicUNet, x):
    """``x``: (N, D, H, W, C_in) → bf16 logits (N, D, H, W, C_out). Spatial
    dims must divide by 16 (four pooling levels; the inference windows do)."""
    n, d, h, wd, cin = x.shape
    if d % 16 or h % 16 or wd % 16:
        raise ValueError(
            f"fast mode needs window dims divisible by 16, got {(d, h, wd)}; "
            "use precision 'parity' for this window"
        )
    x = x.to(torch.bfloat16)
    xcs = x.permute(0, 1, 4, 2, 3).reshape(n, d, cin, h * wd).contiguous()

    x0 = _two_conv_cs(xcs, model.conv_0, h, wd)
    p1, h1, w1 = _maxpool2_cs(x0, h, wd)
    x1 = _two_conv_cs(p1, model.down_1.convs, h1, w1)
    p2, h2, w2 = _maxpool2_cs(x1, h1, w1)
    x2 = _two_conv_cs(p2, model.down_2.convs, h2, w2)
    p3, h3, w3 = _maxpool2_cs(x2, h2, w2)
    x3 = _two_conv_cs(p3, model.down_3.convs, h3, w3)
    p4, h4, w4 = _maxpool2_cs(x3, h3, w3)
    x4 = _two_conv_cs(p4, model.down_4.convs, h4, w4)

    u4 = _upcat_cs(x4, x3, model.upcat_4, h3, w3)
    u3 = _upcat_cs(u4, x2, model.upcat_3, h2, w2)
    u2 = _upcat_cs(u3, x1, model.upcat_2, h1, w1)
    u1 = _upcat_cs(u2, x0, model.upcat_1, h, wd)

    # final 1×1 as a matmul: f32 accumulation, rounded to bf16, + bf16 bias
    fw = model.final_conv.weight.detach()[:, :, 0, 0, 0].t()  # (f5, C_out)
    with full_f32():
        logits = torch.matmul(
            u1.float().transpose(2, 3), fw.to(torch.bfloat16).float()
        ).to(torch.bfloat16)  # (N, D, S, C_out)
    logits = logits + model.final_conv.bias.detach().to(torch.bfloat16)
    return logits.reshape(n, d, h, wd, logits.shape[-1])
