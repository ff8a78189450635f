"""MONAI's BasicUNet as the benchmark sees it: DELiVR's cFos model.

A configuration names its model module by its ``model`` key, and the
harness loads ``benchmark/models/<model>.py`` (``benchlib.cells
.model_module``). Every model module provides these four names, read from
the configuration alone, so that a configuration of another architecture
is a new module, a new reference and a new configuration file:

- ``state_shapes(config)``: (key, shape, bound, centre) of every tensor of
  the state dict that the program and the reference load, in the order of
  the one uniform draw that ``benchlib.weights.make_weights`` cuts;
- ``forward_flops(config)``: the operations of one window's forward by
  kind, with their sum under ``"total"`` (``model.mfu``);
- ``conv3d_cs_shapes(config)``: (name, C_in, C_out, D, H, W) of every 3×3×3
  conv that the program's ``conv3d_cs`` kernel runs in one window's
  forward, in call order (``kernels.conv3d_cs_roofline``);
- ``TINY``: the keys and values that cut the configuration to a size that
  the CPU tests hold.
"""

from __future__ import annotations

import math

from benchlib.arith import conv_ops_bytes

TINY = {"features": [4, 4, 8, 16, 32, 4], "window_zyx": [32, 32, 16]}


def state_shapes(config: dict) -> list:
    """(key, shape, bound, centre) of every tensor of MONAI's state dict.

    Conv and transposed-conv weights and biases are uniform in ±1/√fan_in
    (PyTorch's default Conv init, as the reference's untrained model has
    them); InstanceNorm's scale and shift are drawn near 1 and 0, so that
    the affine step is exercised and not an identity."""
    f = config["features"]
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

    two("conv_0", config["in_channels"], f[0], f[0])
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
        ("final_conv.weight", (config["out_channels"], f[5], 1, 1, 1), 1 / math.sqrt(fan), 0.0),
        ("final_conv.bias", (config["out_channels"],), 1 / math.sqrt(fan), 0.0),
    ])
    return rows


def conv3d_cs_shapes(config: dict) -> list:
    """(name, C_in, C_out, D, H, W) of the 18 3×3×3 convs of one forward, in
    call order; an UpCat's conv reads skip ⧺ upsampled, so its C_in is the
    sum of the two."""
    f, roi = config["features"], config["window_zyx"]
    rows = [("conv_0.0", 0, 1, 0, f[0]), ("conv_0.1", 0, f[0], 0, f[0])]
    for i in range(1, 5):
        rows += [(f"down_{i}.0", i, f[i - 1], 0, f[i]),
                 (f"down_{i}.1", i, f[i], 0, f[i])]
    for i, (skip, up, out) in zip(
        (4, 3, 2, 1),
        ((f[3], f[3], f[3]), (f[2], f[2], f[2]), (f[1], f[1], f[1]),
         (f[0], f[1], f[5])),
    ):
        rows += [(f"upcat_{i}.0", i - 1, skip, up, out),
                 (f"upcat_{i}.1", i - 1, out, 0, out)]
    return [(n, c1 + c2, co, roi[0] >> lvl, roi[1] >> lvl, roi[2] >> lvl)
            for n, lvl, c1, c2, co in rows]


def _deconv_shapes(config: dict) -> list:
    """(name, C_in, C_out, D, H, W at the input) of the four stride-2
    transposed convs of one forward."""
    f, roi = config["features"], config["window_zyx"]
    rows = [("upcat_4", f[4], f[3], 4), ("upcat_3", f[3], f[2], 3),
            ("upcat_2", f[2], f[1], 2), ("upcat_1", f[1], f[1], 1)]
    return [(n, ci, co, roi[0] >> lvl, roi[1] >> lvl, roi[2] >> lvl)
            for n, ci, co, lvl in rows]


def forward_flops(config: dict) -> dict:
    """Operations of one window's forward by kind: the 3×3×3 convs, the
    stride-2 transposed convs (each output voxel takes C_in products from
    one tap) and the final 1×1×1 conv."""
    conv = sum(conv_ops_bytes(1, d, h * w, ci, co)[0]
               for _, ci, co, d, h, w in conv3d_cs_shapes(config))
    deconv = sum(2.0 * ci * co * 8 * d * h * w
                 for _, ci, co, d, h, w in _deconv_shapes(config))
    roi = config["window_zyx"]
    vox = roi[0] * roi[1] * roi[2]
    final = 2.0 * config["features"][5] * config["out_channels"] * vox
    return {"conv3x3x3": conv, "deconv": deconv, "final": final,
            "total": conv + deconv + final}
