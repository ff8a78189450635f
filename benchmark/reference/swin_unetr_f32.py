"""The plain reference of stage 2 for MONAI's SwinUNETR: the network over a
volume by sliding windows, then binarized and re-masked, in float32 with TF32
off.

The sliding window, the background test, test-time augmentation, the mean,
the erosion and the float8 control's rounding are the BasicUNet reference's
(``stage2_f32.py``, loaded from beside this file); the network is written
here anew from MONAI's ``monai/networks/nets/swin_unetr.py`` (v1.x,
``use_v2=False``, ``downsample="merging"``, ``normalize=True``) and its
blocks (``PatchEmbed``, ``MLPBlock``, ``UnetrBasicBlock``, ``UnetrUpBlock``,
``UnetResBlock``, ``UnetOutBlock``), in MONAI's own steps: it imports
nothing of the program:

- the patch embed: a kernel-2, stride-2 conv with bias;
- per stage two Swin blocks, x + attn(LN(x)), then + MLP(LN(·)) (Linear,
  exact GELU, Linear); the tokens zero-padded after the first LayerNorm to
  whole windows, the second block's grid rolled by −3 along each axis above
  7 (an axis of size ≤ 7 is one window of that size, unshifted), windows in
  raster order, q scaled by head_dim^-1/2, the relative-position bias
  ``table[index[:n, :n]]`` of the 7³ window's index (MONAI's slice), the
  shift mask −100 between the 27 regions of ``compute_mask``, softmax; then
  the legacy ``PatchMerging``: neighbours (0,0,0), (1,0,0), (0,1,0), (0,0,1),
  (1,0,1), (0,1,0), (0,0,1), (1,1,1), LayerNorm(8C), Linear(8C → 2C) without
  bias;
- the five hidden states through a LayerNorm without parameters;
- residual conv blocks: lrelu(IN(conv2(lrelu(IN(conv1 x)))) + r), r =
  IN(conv3 x) (1×1×1) where the channels change, else x; convs without bias,
  InstanceNorm without affine (eps 1e-5), LeakyReLU 0.01; up-blocks: a
  stride-2 transposed conv without bias, then (upsampled ⧺ skip); the head a
  1×1×1 conv with bias.

``quant="fp8"`` is the control: the operands of every conv, transposed conv,
Linear and attention product rounded to float8 e4m3 with their scale
(activations per sample, or per window, and weights per tensor), products
summed in float32.
"""

from __future__ import annotations

import importlib.util
import itertools
import os

import torch
import torch.nn.functional as F

EPS = 1e-5  # LayerNorm's and InstanceNorm3d's default, which MONAI keeps
SLOPE = 0.01  # MONAI's UnetResBlock LeakyReLU
ATTN_WINDOWS = 256  # windows a step of the attention, which bounds its scores' memory


def _load_sibling(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_reference_{name}_for_swin", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_base = _load_sibling("stage2_f32")
no_tf32, window_starts, tta_passes, eroded_mask = (
    _base.no_tf32, _base.window_starts, _base.tta_passes, _base.eroded_mask)


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------


def _index(window: int) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of a window³ raster."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel += window - 1
    rel[:, :, 0] *= (2 * window - 1) ** 2
    rel[:, :, 1] *= 2 * window - 1
    return rel.sum(-1)


def _mask(dims, ws, shift, device) -> torch.Tensor:
    """MONAI's ``compute_mask``: (nW, n, n)."""
    img = torch.zeros((1, *dims, 1), device=device)
    for cnt, (d, h, w) in enumerate(itertools.product(
            *[(slice(-a), slice(-a, -s), slice(-s, None)) for a, s in zip(ws, shift)])):
        img[:, d, h, w, :] = cnt
    win = _partition(img, ws)[..., 0]
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def _partition(x, ws):
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def _reverse(x, ws, b, dims):
    d, h, w = dims
    x = x.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def swin_unetr_forward(sd: dict, x: torch.Tensor, config: dict, quant=None) -> torch.Tensor:
    """``x``: (N, 1, D, H, W) float32 → logits (N, C_out, D, H, W) float32."""
    def q(t, per_sample):
        return _base._fp8(t, per_sample) if quant == "fp8" else t

    def linear(t, key, bias=True):
        return F.linear(q(t, True), q(sd[f"{key}.weight"], False),
                        sd[f"{key}.bias"] if bias else None)

    def layer_norm(t, key=None):
        if key is None:
            return F.layer_norm(t, t.shape[-1:], eps=EPS)
        return F.layer_norm(t, t.shape[-1:], sd[f"{key}.weight"], sd[f"{key}.bias"], eps=EPS)

    win = int(config["window"])
    index = _index(win).to(x.device)

    def attention(xw, pre, heads, mask):
        bw, n, c = xw.shape
        qkv = linear(xw, f"{pre}.qkv").reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        table = sd[f"{pre}.relative_position_bias_table"]
        bias = table[index[:n, :n].reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
        out = torch.empty((bw, n, c), device=xw.device)
        for w0 in range(0, bw, ATTN_WINDOWS):
            sl = slice(w0, w0 + ATTN_WINDOWS)
            qs = qkv[0, sl] * (c // heads) ** -0.5
            a = q(qs, True) @ q(qkv[1, sl], True).transpose(-2, -1) + bias[None]
            if mask is not None:
                ids = torch.arange(w0, min(w0 + ATTN_WINDOWS, bw), device=xw.device)
                a = a + mask[ids % mask.shape[0]][:, None]
            p = a.softmax(dim=-1)
            out[sl] = (q(p, True) @ q(qkv[2, sl], True)).transpose(1, 2).reshape(-1, n, c)
        return linear(out, f"{pre}.proj")

    def block(t, pre, heads, shifted):
        b, d, h, w, c = t.shape
        ws = [min(win, s) for s in (d, h, w)]
        shift = [win // 2 if (shifted and s > win) else 0 for s in (d, h, w)]
        dims = [-(-s // a) * a for s, a in zip((d, h, w), ws)]
        y = F.pad(layer_norm(t, f"{pre}.norm1"),
                  (0, 0, 0, dims[2] - w, 0, dims[1] - h, 0, dims[0] - d))
        mask = None
        if any(shift):
            y = torch.roll(y, shifts=[-s for s in shift], dims=(1, 2, 3))
            mask = _mask(dims, ws, shift, t.device)
        y = _reverse(attention(_partition(y, ws), f"{pre}.attn", heads, mask), ws, b, dims)
        if any(shift):
            y = torch.roll(y, shifts=shift, dims=(1, 2, 3))
        t = t + y[:, :d, :h, :w]
        m = layer_norm(t, f"{pre}.norm2")
        return t + linear(F.gelu(linear(m, f"{pre}.mlp.linear1")), f"{pre}.mlp.linear2")

    def merge(t, pre):
        d, h, w = t.shape[1:4]
        t = F.pad(t, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        parts = [t[:, 0::2, 0::2, 0::2], t[:, 1::2, 0::2, 0::2], t[:, 0::2, 1::2, 0::2],
                 t[:, 0::2, 0::2, 1::2], t[:, 1::2, 0::2, 1::2], t[:, 0::2, 1::2, 0::2],
                 t[:, 0::2, 0::2, 1::2], t[:, 1::2, 1::2, 1::2]]
        return linear(layer_norm(torch.cat(parts, -1), f"{pre}.norm"), f"{pre}.reduction",
                      bias=False)

    def conv(t, key, **kw):
        return F.conv3d(q(t, True), q(sd[f"{key}.conv.weight"], False), **kw)

    def inorm(t):  # MONAI's InstanceNorm3d without affine
        return F.instance_norm(t, eps=EPS)

    def res_block(t, pre):
        y = F.leaky_relu(inorm(conv(t, f"{pre}.conv1", padding=1)), SLOPE)
        y = inorm(conv(y, f"{pre}.conv2", padding=1))
        r = inorm(conv(t, f"{pre}.conv3")) if f"{pre}.conv3.conv.weight" in sd else t
        return F.leaky_relu(y + r, SLOPE)

    def up_block(t, skip, pre):
        up = F.conv_transpose3d(q(t, True), q(sd[f"{pre}.transp_conv.conv.weight"], False),
                                stride=2)
        return res_block(torch.cat([up, skip], dim=1), f"{pre}.conv_block")

    # the encoder, channels last
    p = sd["swinViT.patch_embed.proj.weight"]
    t = F.conv3d(q(x, True), q(p, False), sd["swinViT.patch_embed.proj.bias"],
                 stride=p.shape[2]).permute(0, 2, 3, 4, 1)
    hidden = [layer_norm(t)]
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        for b in range(depth):
            t = block(t, f"swinViT.layers{i + 1}.0.blocks.{b}", heads, b % 2 == 1)
        t = merge(t, f"swinViT.layers{i + 1}.0.downsample")
        hidden.append(layer_norm(t))
    hs = [h.permute(0, 4, 1, 2, 3) for h in hidden]

    enc0 = res_block(x, "encoder1.layer")
    enc1 = res_block(hs[0], "encoder2.layer")
    enc2 = res_block(hs[1], "encoder3.layer")
    enc3 = res_block(hs[2], "encoder4.layer")
    dec4 = res_block(hs[4], "encoder10.layer")
    dec3 = up_block(dec4, hs[3], "decoder5")
    dec2 = up_block(dec3, enc3, "decoder4")
    dec1 = up_block(dec2, enc2, "decoder3")
    dec0 = up_block(dec1, enc1, "decoder2")
    out = up_block(dec0, enc0, "decoder1")
    return F.conv3d(q(out, True), q(sd["out.conv.conv.weight"], False), sd["out.conv.conv.bias"])


# --------------------------------------------------------------------------
# sliding windows, TTA, binarization
# --------------------------------------------------------------------------


def mean_logits(volume: torch.Tensor, sd: dict, config: dict, *, quant=None,
                batch: int = 8) -> torch.Tensor:
    """float32 (Z, Y, X): the mean over windows and passes of the logits at
    each voxel, as the BasicUNet reference takes it."""
    device = volume.device
    roi = tuple(config["window_zyx"])
    ov = config["overlap"]
    starts = [window_starts(volume.shape[a], roi[a], ov) for a in range(3)]
    passes = tta_passes(config["tta"])
    acc = torch.zeros(volume.shape, dtype=torch.float32, device=device)
    cnt = torch.zeros(volume.shape, dtype=torch.float32, device=device)
    skip = float(config["skip_logit"])

    def win(t, s):
        return t[s[0]:s[0] + roi[0], s[1]:s[1] + roi[1], s[2]:s[2] + roi[2]]

    active = []
    for s in ((z, y, x) for z in starts[0] for y in starts[1] for x in starts[2]):
        win(cnt, s).add_(len(passes))
        if float(win(volume, s).amax()) > config["background_threshold"]:
            active.append(s)
        else:
            win(acc, s).add_(skip * len(passes))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["tta_noise_seed"]))
    with no_tf32(), torch.no_grad():
        for noise, flip in passes:
            for b0 in range(0, len(active), batch):
                part = active[b0:b0 + batch]
                x = torch.stack([win(volume, s).to(torch.float32) for s in part])
                if noise:
                    x = x + torch.randn(x.shape, generator=gen, device=device,
                                        dtype=torch.float32) * config["tta_noise_std"]
                x = x[:, None]
                if flip is not None:
                    x = torch.flip(x, dims=(flip + 2,))
                y = swin_unetr_forward(sd, x, config, quant)
                if flip is not None:
                    y = torch.flip(y, dims=(flip + 2,))
                for s, logit in zip(part, y[:, 0]):
                    win(acc, s).add_(logit)
    return acc.div_(cnt)


def reference(volume: torch.Tensor, sd: dict, config: dict, *, quant=None,
              batch: int = 8) -> dict:
    """The reference's decision over ``volume`` (Z, Y, X) on the device:
    ``mean`` logits, the eroded input ``mask`` and the ``binary`` result,
    each (Z, Y, X) on that device. ``batch``: windows a forward."""
    mean = mean_logits(volume, sd, config, quant=quant, batch=batch)
    mask = eroded_mask(volume > 0, config["erosion_iters"])
    binary = (torch.sigmoid(mean) >= config["threshold"]) & mask
    return {"mean": mean, "mask": mask, "binary": binary}
