"""3D SwinUNETR in PyTorch, state-dict compatible with MONAI's SwinUNETR.

MONAI's ``monai.networks.nets.SwinUNETR(in_channels, out_channels,
feature_size=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
norm_name="instance", normalize=True, downsample="merging", use_v2=False)``
(Hatamizadeh et al., arXiv:2201.01266; Swin's shifted windows: Liu et al.,
arXiv:2103.14030) at eval, where dropout and drop-path are inactive.
``SwinUNETR`` keeps MONAI's module names, so a MONAI checkpoint loads by key.
``relative_position_index`` is a persistent buffer in MONAI's checkpoints:
here the model computes it from the window and keeps it out of its own
state dict (which holds the learnable tensors alone); loading a state dict
that holds it checks it against the model's own and raises where it
differs.

Forwards, both taking (N, D, H, W, C_in) like ``basic_unet_apply``; the
window's (z, y, x) are the model's three spatial axes in that order:

- parity (``SwinUNETR.forward``): float32 throughout, without TF32;
- fast (``models/swin_unetr_cs.py::apply_cs``): bf16 operands, f32
  accumulation and statistics, every 3×3×3 conv on ``conv3d_cs``, the
  transposed convs on ``deconv2x_cs``, the conv blocks' InstanceNorm +
  LeakyReLU (+ residual) epilogues on ``affine_act_cs`` and the window
  attention on ``window_attention_cs``.

The layer equations (MONAI's code, ``monai/networks/nets/swin_unetr.py`` and
``monai/networks/blocks/{patchembedding,unetr_block,dynunet_block}.py``):

- patch embed: a kernel-2, stride-2 conv with bias, no norm: tokens of
  ``feature_size`` C at half the window's size, channels last;
- four stages (``swinViT.layers1..4``), each two Swin blocks then
  ``PatchMerging``; the second block shifts by 3 (window // 2);
- a block: x + attn(norm1(x)), then + mlp(norm2(·)); the MLP is Linear 4C,
  exact GELU, Linear C (``mlp.linear1``, ``mlp.linear2``);
- attention: the tokens after ``norm1`` are zero-padded at the high end of
  each axis to whole windows; padded tokens take part as keys in every
  window (their k and v are the qkv bias). Per axis a size ≤ 7 takes that
  size as its window and shift 0 (MONAI's ``get_window_size``). Shifted
  blocks roll the padded grid by −3 along the shifted axes, partition it in
  windows of n tokens (raster order z, y, x within a window and over the
  windows), run multi-head attention with head dim C / heads, scale
  head_dim^-1/2 on q, and roll back;
- the relative-position bias of an n-token window is
  ``table[relative_position_index[:n, :n]]`` of the 7³ window's index:
  MONAI's slice, which for a window smaller than 7³ takes the first n
  tokens of the 7³ raster, not the window's own offsets;
- the shift mask (shifted blocks only): the padded, rolled grid splits per
  shifted axis into [0, P − 7), [P − 7, P − 3), [P − 3, P), 27 regions in
  all; scores between tokens of different regions get −100;
- ``PatchMerging`` (``downsample="merging"``, MONAI's legacy 3-D order):
  zero-pad odd sizes, then concatenate the 2×2×2 neighbours at offsets
  (d, h, w) = (0,0,0), (1,0,0), (0,1,0), (0,0,1), (1,0,1), (0,1,0),
  (0,0,1), (1,1,1): two of them twice, (1,1,0) and (0,1,1) never (where
  ``PatchMergingV2`` takes all eight); then LayerNorm(8C) and Linear(8C → 2C)
  without bias;
- the five hidden states (the patch embed's tokens and each stage's merged
  output) go through a LayerNorm without parameters (``normalize=True``);
- conv blocks (``UnetrBasicBlock``, ``UnetrUpBlock`` with ``res_block``):
  ``lrelu(IN(conv2(lrelu(IN(conv1(x))))) + r)`` with r = IN(conv3(x)) where
  C_in ≠ C_out (a 1×1×1 conv), else x; the 3×3×3 and 1×1×1 convs have no
  bias, InstanceNorm has no affine (eps 1e-5), LeakyReLU slope 0.01;
- up-blocks: a 2×2×2 stride-2 transposed conv without bias, concatenated
  (upsampled, skip) in that order, then the residual block 2C → C;
- encoder1 on the input, encoder2..4 on hidden states 0..2, encoder10 on
  hidden state 4; decoder5 (encoder10, hidden 3), decoder4 (·, encoder4),
  decoder3 (·, encoder3), decoder2 (·, encoder2), decoder1 (·, encoder1);
  the head ``out`` is a 1×1×1 conv with bias.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from delivr_cfos_tpu_torch.utils.device import full_f32
from delivr_cfos_tpu_torch.utils.profiling import annotate, count

IN_EPS = 1e-5  # InstanceNorm3d's and LayerNorm's default, which MONAI keeps
LRELU_SLOPE = 0.01
MASK_VALUE = -100.0  # MONAI's compute_mask
# MONAI's legacy PatchMerging order of the 2×2×2 neighbours, (d, h, w)
MERGE_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                 (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))
KEY_PREFIX = "swinViT."  # a SwinUNETR state dict's encoder


@dataclass(frozen=True)
class SwinUNETRConfig:
    in_channels: int = 1
    out_channels: int = 1
    feature_size: int = 48
    depths: tuple = (2, 2, 2, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window: int = 7
    patch: int = 2
    mlp_ratio: int = 4
    # 'parity': f32 forward; 'fast': bf16 operands, f32 accumulation and
    # statistics on the hand-written kernels
    precision: str = "parity"

    def window_bytes(self, roi) -> int:
        """Device bytes one window of ``roi`` takes in a batch of the
        forward, for the engine's batch and slab sizing. Fast: 7 live
        full-resolution tensors of ``feature_size`` bf16 channels; at
        feature size 48 on a (96, 96, 64) window a fast forward's peak on an
        H100 is 6.56 of them, 371.5 MB a window (``max_memory_allocated``
        over the weights at batches 8, 16 and 32). Parity: three times
        that, for its f32 activations and its f32 attention scores (stage
        1's three score tensors, about 1 GB a window, the largest)."""
        fast = 7 * math.prod(int(s) for s in roi) * self.feature_size * 2
        return fast if self.precision == "fast" else 3 * fast

    # it runs on one device: spatial sharding and training raise
    shardable = False

    def build(self, state_dict, device) -> SwinUNETR:
        return build_model(state_dict, self, device)

    def apply(self, model, x):
        return swin_unetr_apply(model, x, self)


# --------------------------------------------------------------------------
# window geometry, shared by both forwards and the kernel's wrapper
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WindowGeometry:
    """One stage's windows: per axis the window ``ws``, the ``shift`` (0
    where the block does not shift or the size is ≤ the window), the
    ``padded`` size and the windows ``grid``; ``n`` tokens a window."""

    size: tuple
    ws: tuple
    shift: tuple
    padded: tuple

    @property
    def grid(self) -> tuple:
        return tuple(p // w for p, w in zip(self.padded, self.ws))

    @property
    def n(self) -> int:
        return math.prod(self.ws)

    @property
    def n_windows(self) -> int:
        return math.prod(self.grid)

    @property
    def shifted(self) -> bool:
        return any(self.shift)


def window_geometry(size, window: int, shifted: bool) -> WindowGeometry:
    """MONAI's ``get_window_size`` and padding for tokens of ``size``."""
    ws = tuple(min(window, s) for s in size)
    shift = tuple(window // 2 if (shifted and s > window) else 0 for s in size)
    padded = tuple(-(-s // w) * w for s, w in zip(size, ws))
    return WindowGeometry(tuple(size), ws, shift, padded)


def relative_position_index(window: int) -> torch.Tensor:
    """(window³, window³) int64: MONAI's index into the (2w−1)³ bias table
    of the relative offset between two tokens of a window³ raster."""
    c = torch.stack(torch.meshgrid(*[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]) * (2 * window - 1) + rel[..., 2]


def shift_mask(geo: WindowGeometry, device) -> torch.Tensor:
    """(nW, n, n) f32: MONAI's ``compute_mask`` over the padded grid, 0
    between tokens of one region and −100 between two."""
    img = torch.zeros(geo.padded, device=device)
    slices = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(geo.ws, geo.shift)]
    for cnt, (d, h, w) in enumerate(itertools.product(*slices)):
        img[d, h, w] = cnt
    win = partition(img[None, ..., None], geo.ws)[..., 0]  # (nW, n)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0).to(torch.float32)


def partition(x, ws) -> torch.Tensor:
    """(B, D, H, W, C) → (B·nW, n, C): MONAI's ``window_partition``."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def reverse(x, ws, b, padded) -> torch.Tensor:
    """(B·nW, n, C) → (B, D, H, W, C): MONAI's ``window_reverse``."""
    d, h, w = padded
    x = x.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def to_windows(x, geo: WindowGeometry) -> torch.Tensor:
    """Tokens (B, D, H, W, C) after norm1 → zero-padded, rolled by −shift,
    partitioned: (B·nW, n, C)."""
    pads = []
    for s, p in zip(reversed(geo.size), reversed(geo.padded)):
        pads += [0, p - s]
    x = F.pad(x, [0, 0] + pads)
    if geo.shifted:
        x = torch.roll(x, shifts=tuple(-s for s in geo.shift), dims=(1, 2, 3))
    return partition(x, geo.ws)


def from_windows(xw, geo: WindowGeometry, b: int) -> torch.Tensor:
    """The inverse of ``to_windows``, cropped to the tokens' size."""
    x = reverse(xw, geo.ws, b, geo.padded)
    if geo.shifted:
        x = torch.roll(x, shifts=geo.shift, dims=(1, 2, 3))
    d, h, w = geo.size
    return x[:, :d, :h, :w]


def merge_gather(x) -> torch.Tensor:
    """(B, D, H, W, C) → (B, ⌈D/2⌉, ⌈H/2⌉, ⌈W/2⌉, 8C): zero-padded odd
    sizes, the neighbours in ``MERGE_OFFSETS`` order."""
    d, h, w = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    return torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE_OFFSETS], dim=-1)


# --------------------------------------------------------------------------
# modules under MONAI's names
# --------------------------------------------------------------------------


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.window = window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """A MONAI checkpoint's index is taken where it equals the model's."""
        key = prefix + "relative_position_index"
        if key in state_dict:
            given = torch.as_tensor(state_dict.pop(key)).to("cpu", torch.int64)
            if not torch.equal(given, self.relative_position_index.cpu()):
                raise ValueError(f"{key} differs from the index of a {self.window}³ window")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def bias(self, n: int) -> torch.Tensor:
        """(heads, n, n) f32: the table at MONAI's sliced index."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)

    def forward(self, xw, mask=None):
        """``xw``: (B·nW, n, C) f32; ``mask``: (nW, n, n) or None."""
        bw, n, c = xw.shape
        qkv = self.qkv(xw).reshape(bw, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1) + self.bias(n)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(bw // nw, nw, self.heads, n, n) + mask[None, :, None]).view(
                bw, self.heads, n, n)
        x = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shifted: bool, mlp_ratio: int):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        """``x``: (B, D, H, W, C) f32 tokens."""
        geo = window_geometry(x.shape[1:4], self.attn.window, self.shifted)
        count("model.window_heads_attended", x.shape[0] * geo.n_windows * self.attn.heads)
        mask = shift_mask(geo, x.device) if geo.shifted else None
        xw = to_windows(self.norm1(x), geo)
        x = x + from_windows(self.attn(xw, mask), geo, x.shape[0])
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        return self.reduction(self.norm(merge_gather(x)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, window, i % 2 == 1, mlp_ratio)
            for i in range(depth))
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv3d(cin, dim, kernel_size=patch, stride=patch)


class SwinTransformer(nn.Module):
    def __init__(self, config: SwinUNETRConfig):
        super().__init__()
        c = config.feature_size
        self.patch_embed = PatchEmbed(config.in_channels, c, config.patch)
        for i in range(4):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                c * 2**i, config.depths[i], config.num_heads[i], config.window,
                config.mlp_ratio)]))

    def stages(self):
        return [self.layers1[0], self.layers2[0], self.layers3[0], self.layers4[0]]

    def forward(self, x):
        """``x``: (N, C_in, D, H, W) f32 → the five normalized hidden states,
        each (N, D', H', W', C') channels last."""
        x = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
        out = [hidden_norm(x)]
        for layer in self.stages():
            x = layer(x)
            out.append(hidden_norm(x))
        return out


def hidden_norm(x):
    """MONAI's ``proj_out(normalize=True)``: LayerNorm over channels without
    parameters."""
    return F.layer_norm(x, x.shape[-1:], eps=IN_EPS)


class _Conv(nn.Module):
    """Holds a conv under MONAI's ``Convolution`` key, ``.conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


def instance_norm(x):
    """InstanceNorm without affine over (D, H, W) of (N, C, D, H, W): what
    MONAI's ``InstanceNorm3d`` calls."""
    return F.instance_norm(x, eps=IN_EPS)


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _Conv(nn.Conv3d(cin, cout, 3, padding=1, bias=False))
        self.conv2 = _Conv(nn.Conv3d(cout, cout, 3, padding=1, bias=False))
        if cin != cout:
            self.conv3 = _Conv(nn.Conv3d(cin, cout, 1, bias=False))

    def forward(self, x):
        y = F.leaky_relu(instance_norm(self.conv1.conv(x)), LRELU_SLOPE)
        y = instance_norm(self.conv2.conv(y))
        r = instance_norm(self.conv3.conv(x)) if hasattr(self, "conv3") else x
        return F.leaky_relu(y + r, LRELU_SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = _Conv(nn.ConvTranspose3d(cin, cout, 2, stride=2, bias=False))
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv.conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _Conv(nn.Conv3d(cin, cout, 1, bias=True))


class SwinUNETR(nn.Module):
    """MONAI SwinUNETR (3-D, ``use_v2=False``) at eval."""

    def __init__(self, config: SwinUNETRConfig = SwinUNETRConfig()):
        super().__init__()
        self.config = config
        c = config.feature_size
        self.swinViT = SwinTransformer(config)
        self.encoder1 = UnetrBasicBlock(config.in_channels, c)
        self.encoder2 = UnetrBasicBlock(c, c)
        self.encoder3 = UnetrBasicBlock(2 * c, 2 * c)
        self.encoder4 = UnetrBasicBlock(4 * c, 4 * c)
        self.encoder10 = UnetrBasicBlock(16 * c, 16 * c)
        self.decoder5 = UnetrUpBlock(16 * c, 8 * c)
        self.decoder4 = UnetrUpBlock(8 * c, 4 * c)
        self.decoder3 = UnetrUpBlock(4 * c, 2 * c)
        self.decoder2 = UnetrUpBlock(2 * c, c)
        self.decoder1 = UnetrUpBlock(c, c)
        self.out = UnetOutBlock(c, config.out_channels)

    def forward(self, x):
        """``x``: (N, D, H, W, C_in) → f32 logits (N, D, H, W, C_out): the
        parity forward. D, H and W must divide by 32."""
        check_window(x.shape[1:4])
        x = x.float().permute(0, 4, 1, 2, 3)
        with full_f32():
            with annotate("model.swin_encoder"):
                hs = [h.permute(0, 4, 1, 2, 3) for h in self.swinViT(x)]
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hs[0])
            enc2 = self.encoder3(hs[1])
            enc3 = self.encoder4(hs[2])
            dec4 = self.encoder10(hs[4])
            dec3 = self.decoder5(dec4, hs[3])
            dec2 = self.decoder4(dec3, enc3)
            dec1 = self.decoder3(dec2, enc2)
            dec0 = self.decoder2(dec1, enc1)
            out = self.decoder1(dec0, enc0)
            logits = self.out.conv.conv(out)
        return logits.permute(0, 2, 3, 4, 1)


def check_window(size) -> None:
    """SwinUNETR needs each spatial size to divide by 2^5 (the patch embed
    and four mergings, each halving, and the decoder doubling back)."""
    if any(int(s) % 32 for s in size):
        raise ValueError(f"SwinUNETR needs window dims divisible by 32, got {tuple(size)}")


def swin_unetr_apply(model: SwinUNETR, x, config: SwinUNETRConfig):
    """Forward in the mode ``config.precision`` names."""
    if config.precision == "fast":
        from delivr_cfos_tpu_torch.models.swin_unetr_cs import apply_cs

        return apply_cs(model, x)
    if config.precision != "parity":
        raise ValueError(f"unknown precision {config.precision!r}")
    return model(x)


def infer_model_config(state_dict) -> SwinUNETRConfig:
    """The architecture config from a MONAI-keyed SwinUNETR state dict."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    proj = sd["swinViT.patch_embed.proj.weight"]
    depths, heads = [], []
    for i in range(1, 5):
        pre = f"swinViT.layers{i}.0.blocks."
        blocks = {int(k[len(pre):].split(".")[0]) for k in sd if k.startswith(pre)}
        depths.append(len(blocks))
        heads.append(int(sd[f"{pre}0.attn.relative_position_bias_table"].shape[1]))
    rows = int(sd["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"].shape[0])
    window = (round(rows ** (1 / 3)) + 1) // 2
    c = int(proj.shape[0])
    return SwinUNETRConfig(
        in_channels=int(proj.shape[1]),
        out_channels=int(sd["out.conv.conv.weight"].shape[0]),
        feature_size=c,
        depths=tuple(depths),
        num_heads=tuple(heads),
        window=window,
        patch=int(proj.shape[2]),
        mlp_ratio=int(sd["swinViT.layers1.0.blocks.0.mlp.linear1.weight"].shape[0]) // c,
    )


def build_model(state_dict, config: SwinUNETRConfig, device) -> SwinUNETR:
    """A ``SwinUNETR`` in eval mode on ``device`` holding ``state_dict`` (a
    DataParallel ``module.`` prefix is stripped). Each
    ``relative_position_index`` the state dict holds must equal the model's
    own."""
    model = SwinUNETR(config)
    model.load_state_dict({(k[len("module."):] if k.startswith("module.") else k):
                           torch.as_tensor(v) for k, v in state_dict.items()})
    return model.to(device).eval()
