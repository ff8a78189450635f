"""Window packing: run G independent sliding windows as one UNet call by
stacking them in the channel dimension with block-diagonal weights.

The port's counterpart of ``delivr_cfos_tpu/models/packing.py``, written on
the port's MONAI-keyed state dicts (``models/convert.py`` gives the keys).
The packed model is the same ``BasicUNet`` (parity or fast forward) built
from ``pack_params(state_dict, G)`` with ``pack_config(config, G)``; only
the weights and the (B, D, H, W, 1) → (B/G, D, H, W, G) window reshape
change.

Semantics are exact: the zero off-diagonal weights contribute exact-zero
terms, InstanceNorm statistics are per channel (so per window, in the fast
forward too, where they come from the conv kernel's per-plane sums), and
pooling, mish, the deconv and the skip concat all act per channel. Only the
order of f32 sums may differ.

The JAX package packs for the TPU, whose matrix unit a 32-channel conv
leaves mostly idle. The H100's tensor cores have no such lane width to
fill, so a packed forward does G× the convolution work per window, the
extra being the zero blocks. Packing stays off every default path: nothing
in the port calls it, as nothing in the JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch

from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig


def _block_diag(w, G):
    """(a, b, ...) → (G·a, G·b, ...) with ``w`` on the diagonal: conv
    weights OIDHW (window g's outputs and inputs) and deconv weights
    (C_in, C_out, 2, 2, 2) alike."""
    a, b = w.shape[:2]
    out = w.new_zeros((G * a, G * b, *w.shape[2:]))
    for g in range(G):
        out[g * a:(g + 1) * a, g * b:(g + 1) * b] = w
    return out


def _block_diag_upcat_conv(w, c_skip, c_up, G):
    """First conv of an UpCat, OIDHW: its input is the concat
    [skip (G·c_skip) | up (G·c_up)] (``basic_unet._up_cat``: skip first), so
    window g's input rows are {g·c_skip ..} ∪ {G·c_skip + g·c_up ..}."""
    co, ci = w.shape[:2]
    if ci != c_skip + c_up:
        raise ValueError(f"UpCat conv takes {ci} channels, not {c_skip} + {c_up}")
    out = w.new_zeros((G * co, G * ci, *w.shape[2:]))
    for g in range(G):
        rows = slice(g * co, (g + 1) * co)
        out[rows, g * c_skip:(g + 1) * c_skip] = w[:, :c_skip]
        out[rows, G * c_skip + g * c_up:G * c_skip + (g + 1) * c_up] = w[:, c_skip:]
    return out


def pack_params(state_dict, G: int) -> dict:
    """A MONAI-keyed BasicUNet state dict → the state dict of the G-window
    packed model: conv, deconv and final-conv weights block-diagonal, every
    bias and InstanceNorm tensor tiled G times."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    packed = {}
    for key, v in sd.items():
        block = key.split(".", 1)[0]
        if key.endswith(".convs.conv_0.conv.weight") and block.startswith("upcat_"):
            c_up = sd[f"{block}.upsample.deconv.weight"].shape[1]
            packed[key] = _block_diag_upcat_conv(v, v.shape[1] - c_up, c_up, G)
        elif v.dim() > 1:
            packed[key] = _block_diag(v, G)
        else:
            packed[key] = v.repeat(G)
    return packed


def pack_config(config: BasicUNetConfig, G: int) -> BasicUNetConfig:
    """The packed model's config: every channel count times G."""
    return dataclasses.replace(
        config,
        in_channels=config.in_channels * G,
        out_channels=config.out_channels * G,
        features=tuple(f * G for f in config.features),
    )


def pack_windows(x, G: int):
    """(B, D, H, W, 1) window batch → (B/G, D, H, W, G): window k·G + g is
    channel g of packed input k. B % G == 0."""
    b = x.shape[0]
    if b % G:
        raise ValueError(f"batch {b} not divisible by pack factor {G}")
    return x[..., 0].reshape(b // G, G, *x.shape[1:4]).movedim(1, -1)


def unpack_logits(y, G: int):
    """(B/G, D, H, W, G) → (B, D, H, W, 1), the inverse of ``pack_windows``."""
    yb = y.movedim(-1, 1)
    return yb.reshape(yb.shape[0] * G, *yb.shape[2:])[..., None]
