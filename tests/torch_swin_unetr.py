"""Independent torch implementation of MONAI's SwinUNETR (3-D, ``use_v2``
False, ``downsample="merging"``, ``normalize=True``), used only as a golden
reference for testing the port's model. NOT part of the framework.

Written from MONAI's code as documented (monai/networks/nets/swin_unetr.py:
``window_partition``, ``window_reverse``, ``get_window_size``,
``compute_mask``, ``WindowAttention``, ``SwinTransformerBlock``,
``PatchMerging``, ``BasicLayer``, ``SwinTransformer``, ``SwinUNETR``; and
monai/networks/blocks: ``PatchEmbed``, ``MLPBlock``, ``UnetrBasicBlock``,
``UnetrUpBlock``, ``UnetResBlock``, ``UnetOutBlock``), in MONAI's channels-
first (N, C, D, H, W) layout, so that its state-dict keys are MONAI's. Three
switches plant the faults the tests' negative controls look for:
``drop_shift_mask``, ``drop_padded_keys`` (padded tokens masked out as keys)
and ``full_bias_index`` (the bias index of the window's own offsets instead
of MONAI's slice of the 7³ index).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FAULTS = {"drop_shift_mask": False, "drop_padded_keys": False, "full_bias_index": False}


def window_partition(x, window_size):
    b, d, h, w, c = x.size()
    x = x.view(b, d // window_size[0], window_size[0], h // window_size[1], window_size[1],
               w // window_size[2], window_size[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(
        -1, window_size[0] * window_size[1] * window_size[2], c)


def window_reverse(windows, window_size, dims):
    b, d, h, w = dims
    x = windows.view(b, d // window_size[0], h // window_size[1], w // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def get_window_size(x_size, window_size, shift_size=None):
    use_window_size = list(window_size)
    use_shift_size = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            if shift_size is not None:
                use_shift_size[i] = 0
    if shift_size is None:
        return tuple(use_window_size)
    return tuple(use_window_size), tuple(use_shift_size)


def compute_mask(dims, window_size, shift_size, device):
    cnt = 0
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    for d in slice(-window_size[0]), slice(-window_size[0], -shift_size[0]), slice(-shift_size[0], None):
        for h in slice(-window_size[1]), slice(-window_size[1], -shift_size[1]), slice(-shift_size[1], None):
            for w in slice(-window_size[2]), slice(-window_size[2], -shift_size[2]), slice(-shift_size[2], None):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size, qkv_bias=True):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window_size[0] - 1) * (2 * window_size[1] - 1) * (2 * window_size[2] - 1),
            num_heads))
        self.register_buffer("relative_position_index", self._index(window_size))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.softmax = nn.Softmax(dim=-1)

    @staticmethod
    def _index(window_size):
        coords = torch.stack(torch.meshgrid(*[torch.arange(s) for s in window_size],
                                            indexing="ij"))
        coords_flatten = torch.flatten(coords, 1)
        relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
        relative_coords = relative_coords.permute(1, 2, 0).contiguous()
        relative_coords[:, :, 0] += window_size[0] - 1
        relative_coords[:, :, 1] += window_size[1] - 1
        relative_coords[:, :, 2] += window_size[2] - 1
        relative_coords[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
        relative_coords[:, :, 1] *= 2 * window_size[2] - 1
        return relative_coords.sum(-1)

    def forward(self, x, mask, n_valid=None, used_window=None):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        if FAULTS["full_bias_index"]:
            index = self._index(used_window).to(x.device)
            bias = self.relative_position_bias_table[index.reshape(-1)].reshape(n, n, -1)
        else:
            bias = self.relative_position_bias_table[
                self.relative_position_index.clone()[:n, :n].reshape(-1)].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.num_heads, n, n) + mask.to(attn.dtype).unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, n, n)
        if n_valid is not None:  # the planted fault: padded keys left out
            nw = n_valid.shape[0]
            keep = n_valid[None, :, None, None, :].expand(b // nw, nw, self.num_heads, n, n)
            attn = attn.masked_fill(~keep.reshape(b, self.num_heads, n, n), float("-inf"))
        attn = self.softmax(attn).to(v.dtype)
        x = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(x)


class MLPBlock(nn.Module):
    def __init__(self, hidden_size, mlp_dim):
        super().__init__()
        self.linear1 = nn.Linear(hidden_size, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden_size)
        self.fn = nn.GELU()

    def forward(self, x):
        return self.linear2(self.fn(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio=4.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward_part1(self, x, mask_matrix):
        x = self.norm1(x)
        b, d, h, w, c = x.shape
        window_size, shift_size = get_window_size((d, h, w), self.window_size, self.shift_size)
        pad_d1 = (window_size[0] - d % window_size[0]) % window_size[0]
        pad_b = (window_size[1] - h % window_size[1]) % window_size[1]
        pad_r = (window_size[2] - w % window_size[2]) % window_size[2]
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
        _, dp, hp, wp, _ = x.shape
        dims = [b, dp, hp, wp]
        valid = torch.zeros((1, dp, hp, wp, 1), dtype=torch.bool, device=x.device)
        valid[:, :d, :h, :w] = True
        if any(i > 0 for i in shift_size):
            shifted_x = torch.roll(x, shifts=(-shift_size[0], -shift_size[1], -shift_size[2]),
                                   dims=(1, 2, 3))
            valid = torch.roll(valid, shifts=(-shift_size[0], -shift_size[1], -shift_size[2]),
                               dims=(1, 2, 3))
            attn_mask = None if FAULTS["drop_shift_mask"] else mask_matrix
        else:
            shifted_x = x
            attn_mask = None
        x_windows = window_partition(shifted_x, window_size)
        n_valid = None
        if FAULTS["drop_padded_keys"]:
            n_valid = window_partition(valid, window_size)[..., 0]
        attn_windows = self.attn(x_windows, mask=attn_mask, n_valid=n_valid,
                                 used_window=window_size)
        attn_windows = attn_windows.view(-1, *(window_size + (c,)))
        shifted_x = window_reverse(attn_windows, window_size, dims)
        if any(i > 0 for i in shift_size):
            x = torch.roll(shifted_x, shifts=(shift_size[0], shift_size[1], shift_size[2]),
                           dims=(1, 2, 3))
        else:
            x = shifted_x
        return x[:, :d, :h, :w, :].contiguous()

    def forward(self, x, mask_matrix):
        shortcut = x
        x = shortcut + self.forward_part1(x, mask_matrix)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI's legacy ``PatchMerging`` (``downsample="merging"``)."""

    def __init__(self, dim):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)

    def forward(self, x):
        b, d, h, w, c = x.shape
        if (h % 2 == 1) or (w % 2 == 1) or (d % 2 == 1):
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x0 = x[:, 0::2, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, 0::2, :]
        x3 = x[:, 0::2, 0::2, 1::2, :]
        x4 = x[:, 1::2, 0::2, 1::2, :]
        x5 = x[:, 0::2, 1::2, 0::2, :]
        x6 = x[:, 0::2, 0::2, 1::2, :]
        x7 = x[:, 1::2, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3, x4, x5, x6, x7], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio=4.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = tuple(i // 2 for i in window_size)
        self.no_shift = tuple(0 for _ in window_size)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 self.no_shift if (i % 2 == 0) else self.shift_size, mlp_ratio)
            for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        b, c, d, h, w = x.size()
        window_size, shift_size = get_window_size((d, h, w), self.window_size, self.shift_size)
        x = x.permute(0, 2, 3, 4, 1)
        dp = int(np.ceil(d / window_size[0])) * window_size[0]
        hp = int(np.ceil(h / window_size[1])) * window_size[1]
        wp = int(np.ceil(w / window_size[2])) * window_size[2]
        attn_mask = compute_mask([dp, hp, wp], window_size, shift_size, x.device)
        for blk in self.blocks:
            x = blk(x, attn_mask)
        x = x.view(b, d, h, w, -1)
        x = self.downsample(x)
        return x.permute(0, 4, 1, 2, 3)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, in_chans, embed_dim):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x)


class SwinTransformer(nn.Module):
    def __init__(self, in_chans, embed_dim, window_size, patch_size, depths, num_heads,
                 mlp_ratio=4.0):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.layers1 = nn.ModuleList()
        self.layers2 = nn.ModuleList()
        self.layers3 = nn.ModuleList()
        self.layers4 = nn.ModuleList()
        for i_layer in range(len(depths)):
            layer = BasicLayer(int(embed_dim * 2**i_layer), depths[i_layer], num_heads[i_layer],
                               window_size, mlp_ratio)
            getattr(self, f"layers{i_layer + 1}").append(layer)

    @staticmethod
    def proj_out(x):
        ch = x.shape[1]
        x = x.permute(0, 2, 3, 4, 1)
        x = F.layer_norm(x, [ch])
        return x.permute(0, 4, 1, 2, 3)

    def forward(self, x):
        x0 = self.patch_embed(x)
        x1 = self.layers1[0](x0.contiguous())
        x2 = self.layers2[0](x1.contiguous())
        x3 = self.layers3[0](x2.contiguous())
        x4 = self.layers4[0](x3.contiguous())
        return [self.proj_out(t) for t in (x0, x1, x2, x3, x4)]


class _Convolution(nn.Sequential):
    def __init__(self, conv):
        super().__init__()
        self.add_module("conv", conv)


class UnetResBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv1 = _Convolution(nn.Conv3d(in_channels, out_channels, 3, padding=1, bias=False))
        self.conv2 = _Convolution(nn.Conv3d(out_channels, out_channels, 3, padding=1, bias=False))
        self.lrelu = nn.LeakyReLU(negative_slope=0.01)
        self.norm1 = nn.InstanceNorm3d(out_channels)
        self.norm2 = nn.InstanceNorm3d(out_channels)
        self.downsample = in_channels != out_channels
        if self.downsample:
            self.conv3 = _Convolution(nn.Conv3d(in_channels, out_channels, 1, bias=False))
            self.norm3 = nn.InstanceNorm3d(out_channels)

    def forward(self, inp):
        residual = inp
        out = self.lrelu(self.norm1(self.conv1(inp)))
        out = self.norm2(self.conv2(out))
        if hasattr(self, "conv3"):
            residual = self.norm3(self.conv3(residual))
        return self.lrelu(out + residual)


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels)

    def forward(self, inp):
        return self.layer(inp)


class UnetrUpBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.transp_conv = _Convolution(nn.ConvTranspose3d(in_channels, out_channels, 2, stride=2,
                                                           bias=False))
        self.conv_block = UnetResBlock(out_channels + out_channels, out_channels)

    def forward(self, inp, skip):
        out = torch.cat((self.transp_conv(inp), skip), dim=1)
        return self.conv_block(out)


class UnetOutBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = _Convolution(nn.Conv3d(in_channels, out_channels, 1, bias=True))

    def forward(self, inp):
        return self.conv(inp)


class SwinUNETR(nn.Module):
    def __init__(self, in_channels=1, out_channels=1, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), feature_size=48):
        super().__init__()
        window_size = (7, 7, 7)
        self.swinViT = SwinTransformer(in_channels, feature_size, window_size, (2, 2, 2), depths,
                                       num_heads)
        fs = feature_size
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, out_channels)

    def forward(self, x_in):
        hidden_states_out = self.swinViT(x_in)
        enc0 = self.encoder1(x_in)
        enc1 = self.encoder2(hidden_states_out[0])
        enc2 = self.encoder3(hidden_states_out[1])
        enc3 = self.encoder4(hidden_states_out[2])
        dec4 = self.encoder10(hidden_states_out[4])
        dec3 = self.decoder5(dec4, hidden_states_out[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        out = self.decoder1(dec0, enc0)
        return self.out(out)


def randomize(model: nn.Module, seed: int, table_std: float = 1.0) -> dict:
    """Random weights in place: every parameter uniform in ±1/√fan_in
    (biases and LayerNorm shifts ±0.1, LayerNorm scales 1 ± 0.2), the
    relative-position tables Gaussian of ``table_std``, wide enough that a
    wrong bias index moves the logits. Returns the state dict."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape, generator=g) * table_std)
            elif ".norm" in name and p.dim() == 1:
                centre = 1.0 if name.endswith("weight") else 0.0
                spread = 0.2 if name.endswith("weight") else 0.1
                p.copy_(centre + (torch.rand(p.shape, generator=g) * 2 - 1) * spread)
            else:
                fan = p[0].numel() if p.dim() > 1 else p.numel()
                if "transp_conv" in name:
                    fan = p.shape[0] * p[0, 0].numel()
                bound = 1.0 / np.sqrt(fan)
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
    return {k: v.clone() for k, v in model.state_dict().items()}
