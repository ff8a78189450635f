"""The port's SwinUNETR (``models/swin_unetr.py``, ``models/swin_unetr_cs.py``)
against an independent plain-torch SwinUNETR with MONAI's key names
(``tests/torch_swin_unetr.py``), on the CPU at one thread, at a tiny cut:
feature size 16, heads (1, 2, 4, 8) (head dim 16, as at the full widths),
depths (2, 2, 2, 2), window (64, 32, 32). Its stages' tokens, (32, 16, 16),
(16, 8, 8), (8, 4, 4) and (4, 2, 2), pad to whole 7³ windows, shift along
all axes, shift along z alone in a (7, 4, 4) window, and take one unshifted
(4, 2, 2) window, so the bias index is sliced in distinct axes.

Also: stage 2 picks the model from the weights' keys, a streamed and an
in-memory ``run_inference`` with SwinUNETR weights write the reference's
binaries, sharding and training refuse SwinUNETR, the span and the counter,
and BasicUNet's route, batch and slab depth at the benchmark cells' shapes
after the sizing moved into the model configs.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import torch_swin_unetr as ref
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.engine import sliding_window, streaming
from delivr_cfos_tpu_torch.engine.sliding_window import SlidingWindowConfig
from delivr_cfos_tpu_torch.models import registry
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig, init_state_dict
from delivr_cfos_tpu_torch.models.swin_unetr import (
    SwinUNETR,
    SwinUNETRConfig,
    build_model,
    relative_position_index,
)
from delivr_cfos_tpu_torch.pipeline.stage02_inference import resolve_model_config, run_inference
from delivr_cfos_tpu_torch.training.train import _check_trainable
from delivr_cfos_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = {"feature_size": 16, "num_heads": (1, 2, 4, 8)}
WINDOW = (64, 32, 32)
# parity: the same f32 operations as the reference in other summation orders
# (matmuls against convs' im2col, fused LayerNorm): 2.4e-6 of |logit| ≤ 3.8
# on this CPU; the bound is 1e-5 of the largest |logit|
PARITY_RTOL = 1e-5
# fast: bf16 operands through ~30 layers, each output rounded once to bf16
# (relative 2^-9) with f32 sums and statistics: 0.031 of |logit| ≤ 3.8
# (0.8 %) on this CPU; the bound is 5 % of the largest |logit|
FAST_RTOL = 0.05


@pytest.fixture(scope="module")
def tiny():
    model = ref.SwinUNETR(**TINY).eval()
    sd = ref.randomize(model, 0)
    x = torch.rand((1, *WINDOW, 1), generator=torch.Generator().manual_seed(1)) * 3
    with torch.no_grad():
        want = model(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    port = build_model(sd, registry.infer_model_config(sd), "cpu")
    return model, sd, x, want, port


def _err(got, want):
    return float((got.float() - want).abs().max()) / float(want.abs().max())


def test_keys_and_shapes_are_monais(tiny):
    """The port's state dict is MONAI's without the relative-position
    indices, which it computes; a MONAI state dict loads by key."""
    model, sd, _, _, port = tiny
    index = "relative_position_index"
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items() if not k.endswith(index)}
    assert sum(k.endswith(index) for k in sd) == 8
    SwinUNETR(registry.infer_model_config(sd)).load_state_dict(sd)
    for key, shape in {
        "swinViT.patch_embed.proj.weight": (16, 1, 2, 2, 2),
        "swinViT.layers1.0.blocks.1.attn.relative_position_bias_table": (2197, 1),
        "swinViT.layers1.0.blocks.1.attn.relative_position_index": (343, 343),
        "swinViT.layers2.0.blocks.0.attn.qkv.weight": (96, 32),
        "swinViT.layers3.0.blocks.1.mlp.linear1.weight": (256, 64),
        "swinViT.layers4.0.downsample.norm.weight": (1024,),
        "swinViT.layers4.0.downsample.reduction.weight": (256, 1024),
        "encoder1.layer.conv3.conv.weight": (16, 1, 1, 1, 1),
        "encoder10.layer.conv2.conv.weight": (256, 256, 3, 3, 3),
        "decoder5.transp_conv.conv.weight": (256, 128, 2, 2, 2),
        "decoder1.conv_block.conv3.conv.weight": (16, 32, 1, 1, 1),
        "out.conv.conv.bias": (1,),
    }.items():
        assert tuple(sd[key].shape) == shape, key
    assert not any(k.startswith("encoder2.layer.conv3") for k in sd)
    assert torch.equal(sd["swinViT.layers1.0.blocks.0.attn.relative_position_index"],
                       relative_position_index(7))
    with torch.device("meta"):
        full = SwinUNETR(SwinUNETRConfig())
        monai = ref.SwinUNETR()
    assert sum(p.numel() for p in full.parameters()) == 62_186_659
    assert {k: v.shape for k, v in full.state_dict().items()} == {
        k: v.shape for k, v in monai.state_dict().items() if not k.endswith(index)}


def test_parity_forward_matches_the_reference(tiny):
    _, _, x, want, port = tiny
    with torch.no_grad():
        got = port(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got, want) <= PARITY_RTOL


def test_fast_forward_on_the_cpu_fallbacks_matches_the_reference(tiny):
    _, _, x, want, port = tiny
    cfg = dataclasses.replace(registry.infer_model_config(port.state_dict()), precision="fast")
    got = cfg.apply(port, x)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _err(got, want) <= FAST_RTOL


@pytest.mark.parametrize("fault", sorted(ref.FAULTS))
def test_negative_controls_fail_the_parity_tolerance(tiny, fault, monkeypatch):
    """The reference with the shift mask dropped, the padded keys left out,
    or the bias index of each window's own offsets in place of MONAI's
    slice, is farther from the port's parity forward than the tolerance."""
    model, _, x, _, port = tiny
    monkeypatch.setitem(ref.FAULTS, fault, True)
    with torch.no_grad():
        bad = model(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        got = port(x)
    assert _err(got, bad) > 20 * PARITY_RTOL


def test_relative_position_index_is_computed_and_checked(tiny):
    _, sd, x, want, _ = tiny
    learnable = {k: v for k, v in sd.items() if not k.endswith("relative_position_index")}
    cfg = registry.infer_model_config(learnable)
    with torch.no_grad():
        assert _err(build_model(learnable, cfg, "cpu")(x), want) <= PARITY_RTOL
    wrong = dict(sd)
    key = "swinViT.layers2.0.blocks.1.attn.relative_position_index"
    wrong[key] = wrong[key].flip(0)
    with pytest.raises(ValueError, match="relative_position_index"):
        build_model(wrong, cfg, "cpu")


def test_stage2_routes_by_keys(tiny):
    _, sd, _, _, _ = tiny
    cfg = registry.infer_model_config(sd)
    assert cfg == SwinUNETRConfig(feature_size=16, num_heads=(1, 2, 4, 8))
    assert registry.infer_model_config({f"module.{k}": v for k, v in sd.items()}) == cfg
    bd = PipelineConfig.from_dict({"blob_detection": {"precision": "auto"}}).blob_detection
    assert resolve_model_config(bd, sd, "cpu") == (cfg, "parity")
    bd = PipelineConfig.from_dict({"blob_detection": {"precision": "fast"}}).blob_detection
    assert resolve_model_config(bd, sd, "cpu") == (
        dataclasses.replace(cfg, precision="fast"), "fast")
    basic = init_state_dict(BasicUNetConfig(features=(4, 4, 8, 16, 32, 4)),
                            torch.Generator().manual_seed(0))
    assert isinstance(registry.infer_model_config(basic), BasicUNetConfig)
    with pytest.raises(ValueError, match=r"swinViT\..*conv_0\.conv_0\.conv\.weight"):
        registry.infer_model_config({"head.weight": torch.zeros(1)})


def _brain(tmp, vol):
    d = tmp / "in" / "brain" / "masked_niftis"
    os.makedirs(d, exist_ok=True)
    np.save(d / "masked_nifti.npy", vol[None, None])

    def raw(out, load_all_ram, **bd):
        return PipelineConfig.from_dict({
            "output_location": str(tmp),
            "blob_detection": {
                "input_location": "in/", "output_location": out, "erosion_iters": 2,
                "window_dimensions": {f"window_dim_{i}": WINDOW[i] for i in range(3)}, **bd,
            },
            "FLAGS": {"TEST_TIME_AUGMENTATION": False, "SAVE_ACTIVATED_OUTPUT": False,
                      "LOAD_ALL_RAM": load_all_ram},
        })
    return raw


def _reference_binaries(model, vol, erosion_iters):
    """The reference's sliding window written out: MONAI's dense grid at
    overlap 0.5, background windows −1000, the mean, sigmoid ≥ 0.5 inside
    the input mask eroded by the 6-connected cross (border value 1)."""
    starts = [sorted({min(i * (w // 2), s - w) for i in range(-(-(s - w) // (w // 2)) + 1)})
              for s, w in zip(vol.shape, WINDOW)]
    acc = np.zeros(vol.shape, np.float64)
    cnt = np.zeros(vol.shape, np.float64)
    for z in starts[0]:
        for y in starts[1]:
            for x in starts[2]:
                sl = (slice(z, z + WINDOW[0]), slice(y, y + WINDOW[1]), slice(x, x + WINDOW[2]))
                win = vol[sl].astype(np.float32)
                if win.max() > 0:
                    with torch.no_grad():
                        logit = model(torch.from_numpy(win)[None, None])[0, 0].numpy()
                else:
                    logit = -1000.0
                acc[sl] += logit
                cnt[sl] += 1
    mean = acc / cnt
    mask = ndimage.binary_erosion(vol > 0, ndimage.generate_binary_structure(3, 1),
                                  iterations=erosion_iters, border_value=1)
    return mean, ((mean >= 0.0) & mask).astype(np.uint8)


def test_run_inference_with_swin_unetr_weights(tiny, tmp_path):
    """Streamed and in device memory, parity on the CPU: the reference's
    binaries wherever its mean logit is farther than 1e-3 from the cut
    (the parity tolerance's order at these logits)."""
    model, sd, _, _, _ = tiny
    rng = np.random.default_rng(5)
    vol = (rng.random((96, 32, 48)) * 3).astype(np.float32)
    vol[:, :, 36:] = 0  # a column of background windows
    vol_u16 = (vol * 100).astype(np.uint16)
    raw = _brain(tmp_path, vol_u16)
    mean, want = _reference_binaries(model, vol_u16, 2)
    far = np.abs(mean) > 1e-3
    assert far.mean() > 0.99 and 0 < want.mean() < 1
    for name, in_memory in (("stream/", False), ("memory/", True)):
        session = run_inference(raw(name, in_memory), "brain", (1, 1, *vol.shape), params=sd,
                                device="cpu")
        got = np.load(os.path.join(session, "binary_segmentations", "binaries.npy"))
        assert got.shape == vol.shape and got.dtype == np.uint8
        assert np.array_equal(got[far], want[far]), name


def test_sharding_and_training_refuse_swin_unetr(tiny, tmp_path):
    _, sd, _, _, _ = tiny
    raw = _brain(tmp_path, np.ones((64, 32, 32), np.uint16))
    with pytest.raises(NotImplementedError, match="spatial sharding"):
        run_inference(raw("out/", False, spatial_shards=2), "brain", (1, 1, 64, 32, 32),
                      params=sd, device="cpu", devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="BasicUNet alone"):
        _check_trainable(SwinUNETRConfig())


def test_span_and_counter_of_each_forward(tiny):
    """Both forwards open ``model.swin_encoder`` once and count every
    attention call's sample-windows × heads: per block 45 windows × 1 head,
    12 × 2, 2 × 4 and 1 × 8 at this cut, two blocks a stage."""
    _, sd, x, _, port = tiny
    cfg = registry.infer_model_config(sd)
    x2 = torch.cat([x, x])
    for mode in ("parity", "fast"):
        profiling.take_counters()
        with torch.profiler.profile() as prof:
            dataclasses.replace(cfg, precision=mode).apply(port, x2)
        spans = [e for e in prof.events() if e.name == "model.swin_encoder"]
        assert len(spans) == 1, mode
        assert profiling.read_counters() == {"model.window_heads_attended": 2 * 2 * 85}
        assert profiling.take_counters() == {"model.window_heads_attended": 2 * 2 * 85}
    cfg.apply(port, x2)  # no profiler: nothing counted
    assert profiling.take_counters() == {}


# the device memory torch.cuda.mem_get_info() reports on the benchmark's
# card, an NVIDIA H100 80GB HBM3
H100_BYTES = 85_017_493_504


@pytest.mark.parametrize("tta", [False, True])
def test_basic_unet_route_batch_and_slab_depth_are_pinned(monkeypatch, tta):
    """At the benchmark cells' shapes (a (768, 480, 384) stream and the
    (144, 480, 384) section, window (96, 96, 64), fast) BasicUNet's weights
    route to BasicUNet, and the engine takes 4 window rows a slab and a
    batch of 128 on an H100, as before the sizing moved into the configs."""
    monkeypatch.setattr(sliding_window, "_device_bytes", lambda device: (H100_BYTES, True))
    sd = init_state_dict(BasicUNetConfig(), torch.Generator().manual_seed(0))
    bd = PipelineConfig.from_dict({"blob_detection": {"precision": "auto"}}).blob_detection
    cfg, mode = resolve_model_config(bd, sd, "cuda")
    assert (cfg, mode) == (BasicUNetConfig(precision="fast"), "fast")
    sw = SlidingWindowConfig(roi=(96, 96, 64), tta=tta)
    assert cfg.window_bytes(sw.roi) == 8 * math.prod(sw.roi) * 32 * 2
    for shape in ((768, 480, 384), (144, 480, 384)):
        k = streaming.slab_depth(sw, cfg, shape, 2, "cuda")
        assert k == 4
        assert streaming.slab_batch_size(sw, cfg, shape, 2, k, "cuda") == 128
