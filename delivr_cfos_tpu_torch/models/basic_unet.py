"""3D BasicUNet in PyTorch, state-dict compatible with MONAI's BasicUNet.

The reference builds ``monai.networks.nets.BasicUNet(spatial_dims=3,
in_channels=1, out_channels=1, features=(32, 32, 64, 128, 256, 32),
dropout=0.1, act="mish")`` and runs it under ``model.eval()``
(reference: inference/inference.py:190-197,261-262): dropout is inactive and
instance norm uses per-sample statistics. ``BasicUNet`` keeps MONAI's module
names, so a reference checkpoint loads by key.

Forwards, all taking (N, D, H, W, C_in) like the JAX package's
``basic_unet_apply``:

- parity (``BasicUNet.forward``): float32 throughout, convolutions without
  TF32 (the JAX parity path uses precision='highest');
- fast (``models/basic_unet_cs.py::apply_cs``): bf16 activations, every
  3×3×3 conv through the hand-written ``conv3d_cs`` CUDA kernel; windows
  whose dims do not divide by 16 take the bf16 form of the parity forward,
  as the JAX package's fast mode falls back to its bf16 ``_apply``.

With ``fused_in_mish`` every conv-block epilogue of the parity forward and
of its bf16 form runs the hand-written ``instance_norm_mish`` CUDA kernel.

Topology (encoder features f0..f4, decoder feature f5):

    conv_0: TwoConv(in → f0)
    down_i: maxpool2 + TwoConv(f_{i-1} → f_i)          i = 1..4
    upcat_4: deconv(f4 → f3) ⧺ skip f3 → TwoConv(→ f3)
    upcat_3: deconv(f3 → f2) ⧺ skip f2 → TwoConv(→ f2)
    upcat_2: deconv(f2 → f1) ⧺ skip f1 → TwoConv(→ f1)
    upcat_1: deconv(f1 → f1) ⧺ skip f0 → TwoConv(→ f5)   (no channel halving)
    final:  1×1×1 conv (f5 → out)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from delivr_cfos_tpu_torch.ops.instance_norm_mish import IN_EPS, instance_norm_mish
from delivr_cfos_tpu_torch.utils.device import full_f32

DEFAULT_FEATURES = (32, 32, 64, 128, 256, 32)


@dataclass(frozen=True)
class BasicUNetConfig:
    in_channels: int = 1
    out_channels: int = 1
    features: tuple = DEFAULT_FEATURES
    # 'parity': f32 forward; 'fast': bf16 activations with f32 accumulation
    # and f32 InstanceNorm statistics on the conv3d_cs kernel
    precision: str = "parity"
    # every InstanceNorm + mish epilogue of the non-conv3d_cs forward (parity,
    # and fast mode's fallback) through the instance_norm_mish kernel, as the
    # JAX package's flag sends it through its Pallas kernel; apply_cs, which
    # takes InstanceNorm from the conv's stats, ignores it as JAX's does
    fused_in_mish: bool = False

    # spatial sharding runs it (parallel/sharded_inference.py)
    shardable = True

    def window_bytes(self, roi) -> int:
        """Device bytes one window of ``roi`` takes in a forward batch, for
        the engine's sizing: about 8 live (roi·f0)-sized activations."""
        dtype_bytes = 2 if self.precision == "fast" else 4
        return 8 * int(math.prod(roi)) * self.features[0] * dtype_bytes

    def build(self, state_dict, device) -> BasicUNet:
        return build_model(state_dict, self, device)

    def apply(self, model, x):
        return basic_unet_apply(model, x, self)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x·tanh(softplus(x)), the JAX package's formula."""
    return x * torch.tanh(F.softplus(x))


def instance_norm(x, scale, bias):
    """Per-sample, per-channel normalization over (D, H, W) with biased
    variance, as eval-mode InstanceNorm3d computes it; unlike
    ``F.instance_norm`` it also takes a single voxel (variance 0), which a
    16³ window reaches at the bottom level."""
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = x.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + IN_EPS)
    return y * scale[None, :, None, None, None] + bias[None, :, None, None, None]


class _ADN(nn.Module):
    """InstanceNorm → (dropout, inactive at eval) → mish; MONAI's 'NDA'."""

    def __init__(self, channels: int):
        super().__init__()
        self.N = nn.InstanceNorm3d(channels, affine=True, eps=IN_EPS)

    def forward(self, x, fused: bool = False):
        """Statistics and arithmetic in f32, output in ``x``'s dtype. Unfused,
        the JAX package's two roundings (after the norm, after mish); fused,
        the kernel's one. Unfused, the scale and bias get gradients (training);
        the kernel has no backward, so the fused path takes them detached."""
        if fused:
            return instance_norm_mish(x.contiguous(), self.N.weight.detach(),
                                      self.N.bias.detach())
        y = instance_norm(x.float(), self.N.weight, self.N.bias).to(x.dtype)
        return mish(y.float()).to(x.dtype)


def _conv(x, conv, **kw):
    """``conv`` in ``x``'s dtype, its bias added after the conv's rounding
    (the JAX package's ``conv + b.astype(x.dtype)``)."""
    y = F.conv3d(x, conv.weight.to(x.dtype), **kw)
    return y + conv.bias.to(x.dtype)[None, :, None, None, None]


def _up_cat(x, x_e, deconv):
    """The stride-2 deconv of ``x``, then MONAI's replicate pad of one at the
    high end of each dim where the encoder feature ``x_e`` is larger (odd
    input sizes), then ``x_e ⧺ up``."""
    x_0 = F.conv_transpose3d(x, deconv.weight.to(x.dtype), stride=2)
    x_0 = x_0 + deconv.bias.to(x.dtype)[None, :, None, None, None]
    pads = []
    for ax in (4, 3, 2):
        pads += [0, x_e.shape[ax] - x_0.shape[ax]]
    if any(pads):
        x_0 = F.pad(x_0, pads, mode="replicate")
    return torch.cat([x_e, x_0], dim=1)


class LocalOps:
    """How the blocks' forwards run each step on one device: the 3×3×3 conv
    with zero padding, the norm+mish epilogue (through ``instance_norm_mish``
    when ``fused``), and ``each(fn, *args)`` for the steps that need no
    neighbour (pool, deconv ⧺ skip, the final 1×1×1 conv). The topology lives
    in the blocks alone: ``parallel/sharded_training.py`` passes a version
    for a row of z-shards, with halo planes and global statistics."""

    def __init__(self, fused: bool = False):
        self.fused = fused

    def conv(self, x, conv):
        return _conv(x, conv, padding=1)

    def norm_mish(self, x, adn):
        return adn(x, self.fused)

    def each(self, fn, *args):
        return fn(*args)


class _Convolution(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel_size=3, padding=1, bias=True)
        self.adn = _ADN(cout)

    def forward(self, x, ops: LocalOps):
        return ops.norm_mish(ops.conv(x, self.conv), self.adn)


class _TwoConv(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int):
        super().__init__()
        self.conv_0 = _Convolution(cin, cmid)
        self.conv_1 = _Convolution(cmid, cout)

    def forward(self, x, ops: LocalOps):
        return self.conv_1(self.conv_0(x, ops), ops)


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.max_pooling = nn.MaxPool3d(2)
        self.convs = _TwoConv(cin, cout, cout)

    def forward(self, x, ops: LocalOps):
        return self.convs(ops.each(self.max_pooling, x), ops)


class _Upsample(nn.Module):
    """Holds the deconv under MONAI's key; ``_up_cat`` runs it."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = nn.ConvTranspose3d(cin, cout, kernel_size=2, stride=2)


class _UpCat(nn.Module):
    def __init__(self, cin: int, c_skip: int, cout: int, halves: bool = True):
        super().__init__()
        c_up = cin // 2 if halves else cin
        self.upsample = _Upsample(cin, c_up)
        self.convs = _TwoConv(c_skip + c_up, cout, cout)

    def forward(self, x, x_e, ops: LocalOps):
        return self.convs(ops.each(_up_cat, x, x_e, self.upsample.deconv), ops)


class BasicUNet(nn.Module):
    """MONAI BasicUNet(3d, act=mish) at eval."""

    def __init__(self, config: BasicUNetConfig = BasicUNetConfig()):
        super().__init__()
        f = config.features
        self.conv_0 = _TwoConv(config.in_channels, f[0], f[0])
        self.down_1 = _Down(f[0], f[1])
        self.down_2 = _Down(f[1], f[2])
        self.down_3 = _Down(f[2], f[3])
        self.down_4 = _Down(f[3], f[4])
        self.upcat_4 = _UpCat(f[4], f[3], f[3])
        self.upcat_3 = _UpCat(f[3], f[2], f[2])
        self.upcat_2 = _UpCat(f[2], f[1], f[1])
        self.upcat_1 = _UpCat(f[1], f[0], f[5], halves=False)
        self.final_conv = nn.Conv3d(f[5], config.out_channels, kernel_size=1)

    def forward(self, x, dtype=torch.float32, fused: bool = False):
        """``x``: (N, D, H, W, C_in) → logits (N, D, H, W, C_out) in ``dtype``.

        f32 is the parity forward. bf16 is its fast-mode form, the
        counterpart of the JAX ``_apply`` with compute_dtype bf16: bf16
        activations, bf16 convolutions with f32 accumulation, biases added in
        bf16, InstanceNorm statistics in f32. ``fused`` sends every epilogue
        through ``instance_norm_mish``; ``basic_unet_apply`` passes the
        config's ``fused_in_mish`` here, its one source."""
        x = x.to(dtype).permute(0, 4, 1, 2, 3)
        with full_f32():
            logits = self.body(x, LocalOps(fused))
        return logits.permute(0, 2, 3, 4, 1)

    def body(self, x, ops: LocalOps):
        """The topology on channels-first ``x``, every step through
        ``ops``."""
        x0 = self.conv_0(x, ops)
        x1 = self.down_1(x0, ops)
        x2 = self.down_2(x1, ops)
        x3 = self.down_3(x2, ops)
        x4 = self.down_4(x3, ops)
        u4 = self.upcat_4(x4, x3, ops)
        u3 = self.upcat_3(u4, x2, ops)
        u2 = self.upcat_2(u3, x1, ops)
        u1 = self.upcat_1(u2, x0, ops)
        return ops.each(_conv, u1, self.final_conv)


def basic_unet_apply(model: BasicUNet, x, config: BasicUNetConfig):
    """Forward in the mode ``config.precision`` names. Fast mode runs
    ``apply_cs`` where the window dims divide by 16 (its four pooling
    levels) and the bf16 forward elsewhere, as the JAX package does."""
    if config.precision == "fast":
        if all(s % 16 == 0 for s in x.shape[1:4]):
            from delivr_cfos_tpu_torch.models.basic_unet_cs import apply_cs

            return apply_cs(model, x)
        return model(x, torch.bfloat16, config.fused_in_mish)
    if config.precision != "parity":
        raise ValueError(f"unknown precision {config.precision!r}")
    return model(x, torch.float32, config.fused_in_mish)


def infer_model_config(state_dict) -> BasicUNetConfig:
    """Reconstruct the architecture config from a MONAI-keyed state dict."""
    def cout(key):
        return int(state_dict[key].shape[0])

    features = (
        cout("conv_0.conv_1.conv.weight"),
        cout("down_1.convs.conv_1.conv.weight"),
        cout("down_2.convs.conv_1.conv.weight"),
        cout("down_3.convs.conv_1.conv.weight"),
        cout("down_4.convs.conv_1.conv.weight"),
        cout("upcat_1.convs.conv_1.conv.weight"),
    )
    return BasicUNetConfig(
        in_channels=int(state_dict["conv_0.conv_0.conv.weight"].shape[1]),
        out_channels=cout("final_conv.weight"),
        features=features,
    )


def init_state_dict(config: BasicUNetConfig, generator: torch.Generator) -> dict:
    """Random weights from ``generator`` with the JAX package's init_params
    distributions (kaiming-uniform, torch's Conv default): conv weights and
    biases uniform in ±bound, InstanceNorm scale 1 and bias 0."""
    model = BasicUNet(config)
    sd = {}
    for name, t in model.state_dict().items():
        if ".adn.N." in name:
            sd[name] = (torch.ones_like(t) if name.endswith("weight")
                        else torch.zeros_like(t))
            continue
        if name.startswith("final_conv"):
            bound = math.sqrt(1.0 / t.shape[1] if t.dim() > 1 else 0.0)
        elif "deconv" in name:
            fan_in = model.get_submodule(name.rsplit(".", 1)[0]).in_channels * 8
            bound = 1.0 / math.sqrt(fan_in)
        else:
            w = model.get_submodule(name.rsplit(".", 1)[0]).weight
            fan_in = w.shape[1] * 27
            gain = math.sqrt(2.0 / (1 + 5**2))  # as the JAX init_params has it
            bound = (gain * math.sqrt(3.0 / fan_in) if name.endswith("weight")
                     else 1.0 / math.sqrt(fan_in))
        sd[name] = (torch.rand(t.shape, generator=generator) * 2 - 1) * bound
    return sd


def build_model(state_dict, config: BasicUNetConfig, device) -> BasicUNet:
    """A ``BasicUNet`` in eval mode on ``device`` holding ``state_dict``."""
    model = BasicUNet(config)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model.to(device).eval()
