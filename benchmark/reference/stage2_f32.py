"""The plain reference of stage 2: DELiVR's BasicUNet over a volume by
sliding windows, then binarized and re-masked, in float32 with TF32 off.

It follows the published method (erturklab/delivr_cfos,
inference/inference.py and inference/sliding_window_inferer.py, with MONAI's
BasicUNet and dense_patch_slices), written anew from it; it imports nothing
of the program:

- the dense window grid of (96, 96, 64) windows at overlap 0.5: stride
  int(roi·(1 − overlap)), the last start clamped to the edge;
- a window whose maximum is not above the background threshold is not run:
  it adds the constant logit −1000 for each pass;
- test-time augmentation: 1 base pass + 4 × (noise, noise + z-flip,
  noise + y-flip), Gaussian noise of std 1e-3 on the window's intensities;
- every window adds its logits with weight 1 (constant importance), and the
  mean is the sum over the count of windows and passes;
- MONAI BasicUNet at eval: each block conv3d → InstanceNorm (per sample and
  channel, biased variance, eps 1e-5, affine) → mish; max-pool 2; UpCat =
  stride-2 transposed conv ⧺ skip; a final 1×1×1 conv;
- binaries: sigmoid(mean) ≥ 0.5, AND the input > 0 mask eroded 30 times by
  the 6-connected cross with voxels outside the array counting as
  foreground (scipy's binary_erosion with border_value=1), computed here as
  "the taxicab distance to the nearest zero voxel exceeds 30".

The TTA noise is the reference's own: one generator seeded from the
configuration's noise seed, one draw per batch of windows in pass order. It
does not follow the program's draws (a generator per slab, a draw per
window batch, both sized by the program from device memory): noise of std
1e-3 on intensities of at least 1 moves no comparison here.

``quant="fp8"`` is the control: every conv's and transposed conv's operands,
activations per sample and weights per tensor, rounded to float8 e4m3 with
their scale, products summed in float32.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

IN_EPS = 1e-5  # torch.nn.InstanceNorm3d's default, which MONAI keeps
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------


def _fp8(t: torch.Tensor, per_sample: bool) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (each sample's, or the tensor's) to the format's largest."""
    if per_sample:
        amax = t.abs().flatten(1).amax(dim=1).view(-1, *([1] * (t.dim() - 1)))
    else:
        amax = t.abs().amax()
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def unet_forward(sd: dict, x: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    """``x``: (N, 1, D, H, W) float32 → logits (N, 1, D, H, W) float32."""
    def q(t, per_sample):
        return _fp8(t, per_sample) if quant == "fp8" else t

    def conv(t, key, padding):
        return F.conv3d(q(t, True), q(sd[f"{key}.weight"], False), sd[f"{key}.bias"],
                        padding=padding)

    def norm_mish(t, key):
        mean = t.mean(dim=(2, 3, 4), keepdim=True)
        var = ((t - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
        y = (t - mean) / torch.sqrt(var + IN_EPS)
        y = y * sd[f"{key}.weight"].view(1, -1, 1, 1, 1) + sd[f"{key}.bias"].view(1, -1, 1, 1, 1)
        return y * torch.tanh(F.softplus(y))

    def two_conv(t, prefix):
        for c in ("conv_0", "conv_1"):
            t = norm_mish(conv(t, f"{prefix}.{c}.conv", 1), f"{prefix}.{c}.adn.N")
        return t

    def up_cat(t, skip, prefix):
        key = f"{prefix}.upsample.deconv"
        up = F.conv_transpose3d(q(t, True), q(sd[f"{key}.weight"], False),
                                sd[f"{key}.bias"], stride=2)
        return two_conv(torch.cat([skip, up], dim=1), f"{prefix}.convs")

    x0 = two_conv(x, "conv_0")
    x1 = two_conv(F.max_pool3d(x0, 2), "down_1.convs")
    x2 = two_conv(F.max_pool3d(x1, 2), "down_2.convs")
    x3 = two_conv(F.max_pool3d(x2, 2), "down_3.convs")
    x4 = two_conv(F.max_pool3d(x3, 2), "down_4.convs")
    u4 = up_cat(x4, x3, "upcat_4")
    u3 = up_cat(u4, x2, "upcat_3")
    u2 = up_cat(u3, x1, "upcat_2")
    u1 = up_cat(u2, x0, "upcat_1")
    return conv(u1, "final_conv", 0)


# --------------------------------------------------------------------------
# sliding windows, TTA, binarization
# --------------------------------------------------------------------------


def window_starts(size: int, roi: int, overlap: float) -> list[int]:
    if roi >= size:
        return [0]
    stride = int(roi * (1 - overlap)) or 1
    n = math.ceil((size - roi) / stride) + 1
    return [min(i * stride, size - roi) for i in range(n)]


def tta_passes(tta: bool) -> list:
    """(noise, flipped axis of (z, y, x)) per pass."""
    passes = [(False, None)]
    if tta:
        for _ in range(4):
            passes += [(True, None), (True, 0), (True, 1)]
    return passes


def mean_logits(volume: torch.Tensor, sd: dict, config: dict, *, quant=None,
                batch: int = 8) -> torch.Tensor:
    """float32 (Z, Y, X): the mean over windows and passes of the logits at
    each voxel. ``volume``: (Z, Y, X) intensities on the device."""
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
                y = unet_forward(sd, x, quant)
                if flip is not None:
                    y = torch.flip(y, dims=(flip + 2,))
                for s, logit in zip(part, y[:, 0]):
                    win(acc, s).add_(logit)
    return acc.div_(cnt)


def eroded_mask(nonzero: torch.Tensor, iterations: int) -> torch.Tensor:
    """bool (Z, Y, X): voxels whose taxicab distance to the nearest zero
    voxel of ``nonzero`` exceeds ``iterations`` (voxels outside the array
    count as nonzero), which is ``iterations`` erosions by the 6-connected
    cross with border value 1. The distance is separable: one forward and
    one backward sweep along each axis, capped at iterations + 1."""
    cap = iterations + 1
    d = torch.where(nonzero, cap, 0).to(torch.int32)
    for axis in range(3):
        n = d.shape[axis]
        for i in range(1, n):
            cur, prev = d.select(axis, i), d.select(axis, i - 1)
            torch.minimum(cur, prev + 1, out=cur)
        for i in range(n - 2, -1, -1):
            cur, nxt = d.select(axis, i), d.select(axis, i + 1)
            torch.minimum(cur, nxt + 1, out=cur)
    return d > iterations


def reference(volume: torch.Tensor, sd: dict, config: dict, *, quant=None,
              batch: int = 8) -> dict:
    """The reference's decision over ``volume`` (Z, Y, X) on the device:
    ``mean`` logits, the eroded input ``mask`` and the ``binary`` result,
    each (Z, Y, X) on that device."""
    mean = mean_logits(volume, sd, config, quant=quant, batch=batch)
    mask = eroded_mask(volume > 0, config["erosion_iters"])
    binary = (torch.sigmoid(mean) >= config["threshold"]) & mask
    return {"mean": mean, "mask": mask, "binary": binary}
