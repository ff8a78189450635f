"""Random weights of MONAI's BasicUNet from the seed, made on the device in
one draw, under MONAI's state-dict keys (the checkpoint format that both the
program and the reference load).

Conv and transposed-conv weights and biases are uniform in ±1/√fan_in
(PyTorch's default Conv init, as the reference's untrained model has them);
InstanceNorm's scale and shift are drawn near 1 and 0, so that the affine
step is exercised and not an identity.
"""

from __future__ import annotations

import math

import torch

from benchlib.phantom import generator


def state_shapes(features, in_channels: int = 1, out_channels: int = 1) -> list:
    """(key, shape, bound, centre) of every tensor of the state dict."""
    f = features
    rows = []

    def conv(prefix, cin, cout):
        fan = cin * 27
        rows.extend([
            (f"{prefix}.conv.weight", (cout, cin, 3, 3, 3), 1 / math.sqrt(fan), 0.0),
            (f"{prefix}.conv.bias", (cout,), 1 / math.sqrt(fan), 0.0),
            (f"{prefix}.adn.N.weight", (cout,), 0.2, 1.0),
            (f"{prefix}.adn.N.bias", (cout,), 0.1, 0.0),
        ])

    def two(prefix, cin, cmid, cout):
        conv(f"{prefix}.conv_0", cin, cmid)
        conv(f"{prefix}.conv_1", cmid, cout)

    two("conv_0", in_channels, f[0], f[0])
    for i in range(1, 5):
        two(f"down_{i}.convs", f[i - 1], f[i], f[i])
    for i, (cin, skip, cout, halves) in zip(
        (4, 3, 2, 1),
        ((f[4], f[3], f[3], True), (f[3], f[2], f[2], True),
         (f[2], f[1], f[1], True), (f[1], f[0], f[5], False)),
    ):
        c_up = cin // 2 if halves else cin
        fan = cin * 8
        rows.extend([
            (f"upcat_{i}.upsample.deconv.weight", (cin, c_up, 2, 2, 2), 1 / math.sqrt(fan), 0.0),
            (f"upcat_{i}.upsample.deconv.bias", (c_up,), 1 / math.sqrt(fan), 0.0),
        ])
        two(f"upcat_{i}.convs", skip + c_up, cout, cout)
    fan = f[5]
    rows.extend([
        ("final_conv.weight", (out_channels, f[5], 1, 1, 1), 1 / math.sqrt(fan), 0.0),
        ("final_conv.bias", (out_channels,), 1 / math.sqrt(fan), 0.0),
    ])
    return rows


def make_weights(config: dict, seed: int, device) -> dict:
    """A float32 MONAI-keyed state dict on ``device`` from ``seed``: one
    uniform draw, cut into the tensors and scaled."""
    rows = state_shapes(config["features"], config["in_channels"], config["out_channels"])
    sizes = [math.prod(shape) for _, shape, _, _ in rows]
    u = torch.rand(sum(sizes), generator=generator(seed, device), device=device)
    u = u.mul_(2).sub_(1)
    sd = {}
    for (key, shape, bound, centre), part in zip(rows, torch.split(u, sizes)):
        sd[key] = (part * bound + centre).view(shape)
    return sd
