"""MONAI's SwinUNETR as the benchmark sees it (arXiv:2201.01266, MONAI's
``monai.networks.nets.SwinUNETR``), at the configuration's widths.

The four names that ``benchmark/models/basic_unet.py`` states, and a fifth:
``window_attention_shapes`` (the attention calls of one window's forward,
``kernels.window_attention_roofline`` and ``model.attended_share``).
"""

from __future__ import annotations

import math

from benchlib.arith import conv_ops_bytes

# the window's bottom stage is (2, 2, 1) tokens: with two voxels a channel
# InstanceNorm turns float32 summation noise into outputs of order 1, which
# the decoder carries to the logits
TINY = {"feature_size": 16, "num_heads": [1, 2, 4, 8], "depths": [2, 2, 2, 2],
        "window_zyx": [64, 64, 32]}
# the relative-position tables are uniform in +-TABLE_BOUND, so that the bias
# steers the attention (MONAI initialises them with a truncated normal of std
# 0.02)
TABLE_BOUND = 2.0
# the traffic's intensity scale (texture 150-400, nuclei to 4000): the patch
# embed's weights are divided by it, so that its tokens are of order 1, as in
# a network trained on scaled intensities, and the blocks' attention moves the
# residual stream
INPUT_SCALE = 2000.0


def _stage_size(config: dict, stage: int) -> list:
    """The tokens' size per axis at ``stage`` (0: the patch embed's)."""
    p = config["patch"]
    return [s // p // 2**stage for s in config["window_zyx"]]


def state_shapes(config: dict) -> list:
    """(key, shape, bound, centre) of every learnable tensor of MONAI's
    state dict (the relative-position indices are buffers, which the
    program computes). Conv and Linear weights and biases uniform in
    ±1/√fan_in (PyTorch's default init), except where the attention would
    not reach the logits (random weights there leave them to the
    full-resolution conv path, which no attention fault can move):

    - the patch embed's weights ±1/(√fan_in·INPUT_SCALE), tokens of order 1;
    - qkv and proj ±√3/√C, outputs of unit variance from the LayerNorm's,
      so that the scaled scores spread by about 1 and a head picks its keys;
    - the transposed convs ±1/√C_in, the fan of one output voxel of a
      kernel-2, stride-2 transposed conv, so that the upsampled half of an
      up-block's input is of the skip's size and the deep, attended path
      reaches the head.

    LayerNorm scales 1 ± 0.2 and shifts ±0.1, so that the affine step is
    exercised."""
    fs, cin, p = config["feature_size"], config["in_channels"], config["patch"]
    win, mlp = config["window"], config["mlp_ratio"]
    rows = []

    def lin(key, i, o, bias=True, gain=1.0):
        rows.append((f"{key}.weight", (o, i), gain / math.sqrt(i), 0.0))
        if bias:
            rows.append((f"{key}.bias", (o,), 1 / math.sqrt(i), 0.0))

    def norm(key, c):
        rows.extend([(f"{key}.weight", (c,), 0.2, 1.0), (f"{key}.bias", (c,), 0.1, 0.0)])

    def conv(key, ci, co, k):
        rows.append((f"{key}.conv.weight", (co, ci, k, k, k), 1 / math.sqrt(ci * k**3), 0.0))

    def res_block(pre, ci, co):
        conv(f"{pre}.conv1", ci, co, 3)
        conv(f"{pre}.conv2", co, co, 3)
        if ci != co:
            conv(f"{pre}.conv3", ci, co, 1)

    fan = cin * p**3
    rows.extend([("swinViT.patch_embed.proj.weight", (fs, cin, p, p, p),
                  1 / (math.sqrt(fan) * INPUT_SCALE), 0.0),
                 ("swinViT.patch_embed.proj.bias", (fs,), 1 / math.sqrt(fan), 0.0)])
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        c = fs * 2**i
        for b in range(depth):
            pre = f"swinViT.layers{i + 1}.0.blocks.{b}"
            norm(f"{pre}.norm1", c)
            rows.append((f"{pre}.attn.relative_position_bias_table",
                         ((2 * win - 1) ** 3, heads), TABLE_BOUND, 0.0))
            lin(f"{pre}.attn.qkv", c, 3 * c, gain=math.sqrt(3))
            lin(f"{pre}.attn.proj", c, c, gain=math.sqrt(3))
            norm(f"{pre}.norm2", c)
            lin(f"{pre}.mlp.linear1", c, mlp * c)
            lin(f"{pre}.mlp.linear2", mlp * c, c)
        norm(f"swinViT.layers{i + 1}.0.downsample.norm", 8 * c)
        lin(f"swinViT.layers{i + 1}.0.downsample.reduction", 8 * c, 2 * c, bias=False)
    res_block("encoder1.layer", cin, fs)
    for name, c in (("encoder2", fs), ("encoder3", 2 * fs), ("encoder4", 4 * fs),
                    ("encoder10", 16 * fs)):
        res_block(f"{name}.layer", c, c)
    for name, ci, co in _up_blocks(fs):
        rows.append((f"{name}.transp_conv.conv.weight", (ci, co, 2, 2, 2),
                     1 / math.sqrt(ci), 0.0))
        res_block(f"{name}.conv_block", 2 * co, co)
    rows.extend([("out.conv.conv.weight", (config["out_channels"], fs, 1, 1, 1),
                  1 / math.sqrt(fs), 0.0),
                 ("out.conv.conv.bias", (config["out_channels"],), 1 / math.sqrt(fs), 0.0)])
    return rows


def _up_blocks(fs: int) -> list:
    """(name, C_in, C_out) of the five up-blocks, in call order."""
    return [("decoder5", 16 * fs, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
            ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs), ("decoder1", fs, fs)]


def _level(config: dict, lvl: int) -> tuple:
    return tuple(s >> lvl for s in config["window_zyx"])


def conv3d_cs_shapes(config: dict) -> list:
    """(name, C_in, C_out, D, H, W) of the 20 3×3×3 convs of one forward, in
    call order: the encoders' residual blocks, then each up-block's (its
    first conv reads upsampled ⧺ skip, 2·C_out channels)."""
    fs, cin = config["feature_size"], config["in_channels"]
    rows = [("encoder1.conv1", cin, fs, 0), ("encoder1.conv2", fs, fs, 0)]
    for name, c, lvl in (("encoder2", fs, 1), ("encoder3", 2 * fs, 2), ("encoder4", 4 * fs, 3),
                         ("encoder10", 16 * fs, 5)):
        rows += [(f"{name}.conv1", c, c, lvl), (f"{name}.conv2", c, c, lvl)]
    for (name, _, co), lvl in zip(_up_blocks(fs), (4, 3, 2, 1, 0)):
        rows += [(f"{name}.conv1", 2 * co, co, lvl), (f"{name}.conv2", co, co, lvl)]
    return [(n, ci, co, *_level(config, lvl)) for n, ci, co, lvl in rows]


def window_attention_shapes(config: dict) -> list:
    """(stage, windows a sample with padding, heads, tokens a window,
    shifted) of every attention call of one forward, in call order: per
    axis a size above the window takes the window and, in a stage's odd
    blocks, the shift; a size at most the window is one window of that size,
    unshifted (MONAI's ``get_window_size``)."""
    win = config["window"]
    rows = []
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        size = _stage_size(config, i)
        ws = [min(win, s) for s in size]
        windows = math.prod(-(-s // w) for s, w in zip(size, ws))
        for b in range(depth):
            shifted = b % 2 == 1 and any(s > win for s in size)
            rows.append((i + 1, windows, heads, math.prod(ws), shifted))
    return rows


def forward_flops(config: dict) -> dict:
    """Operations of one window's forward by kind: the 3×3×3 convs, the
    1×1×1 convs (residual convs and the head), the transposed convs, the
    patch embed, the encoder's Linears (qkv and proj over the padded
    windows' tokens, the MLP over the tokens, the mergings), and the
    attention's QKᵀ and PV (2·n²·head_dim each, a window and head)."""
    fs, cin, cout = config["feature_size"], config["in_channels"], config["out_channels"]
    p, mlp, win = config["patch"], config["mlp_ratio"], config["window"]
    conv = sum(conv_ops_bytes(1, d, h * w, ci, co)[0]
               for _, ci, co, d, h, w in conv3d_cs_shapes(config))
    vox = math.prod(config["window_zyx"])
    one = 2.0 * cin * fs * vox + 2.0 * fs * cout * vox  # encoder1's residual conv, the head
    for (_, _, co), lvl in zip(_up_blocks(fs), (4, 3, 2, 1, 0)):
        one += 2.0 * 2 * co * co * math.prod(_level(config, lvl))
    deconv = sum(2.0 * ci * co * 8 * math.prod(_level(config, lvl))
                 for (_, ci, co), lvl in zip(_up_blocks(fs), (5, 4, 3, 2, 1)))
    tokens0 = math.prod(_stage_size(config, 0))
    embed = 2.0 * cin * p**3 * fs * tokens0
    linear = attention = 0.0
    for stage, windows, heads, n, _ in window_attention_shapes(config):
        c = fs * 2 ** (stage - 1)
        tokens = math.prod(_stage_size(config, stage - 1))
        padded = windows * n
        linear += 2.0 * padded * c * 4 * c  # qkv (3C) and proj (C)
        linear += 2.0 * tokens * c * mlp * c * 2  # the MLP
        attention += 4.0 * windows * heads * n * n * (c // heads)
    for i in range(len(config["depths"])):
        c = fs * 2**i
        merged = math.prod(-(-s // 2) for s in _stage_size(config, i))
        linear += 2.0 * merged * 8 * c * 2 * c
    total = conv + one + deconv + embed + linear + attention
    return {"conv3x3x3": conv, "conv1x1x1": one, "deconv": deconv, "patch_embed": embed,
            "linear": linear, "attention": attention, "total": total}
