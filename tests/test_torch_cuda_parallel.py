"""Sharded inference and the sharded labeler on the card, on meshes that
name the one card several times: the per-shard window grids, the halo
copies and the hand-written kernels in every shard. Marker ``cuda``; skips
without a card; imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py
"""

import math

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.engine.sliding_window import (
    SlidingWindowConfig,
    _dim_starts,
    infer_volume,
    scan_interval,
)
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.ops.connected_components import label_volume_host
from delivr_cfos_tpu_torch.ops.conv3d_cs import (
    conv3d_cs,
    conv3d_cs_direct,
    conv3d_cs_pack,
    conv3d_cs_packed,
)
from delivr_cfos_tpu_torch.ops.deconv2x_cs import deconv2x_cs
from delivr_cfos_tpu_torch.parallel import make_mesh, plan_sharding, sharded_infer_volume
from delivr_cfos_tpu_torch.parallel.sharded_cc import label_volume_sharded

pytestmark = pytest.mark.cuda

ROI = (96, 96, 64)
BATCH = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shards' kernels are CUDA's")
    return torch.device("cuda")


def _volume(shape=(192, 192, 128)):
    rng = np.random.default_rng(0)
    vol = np.zeros(shape, np.uint16)
    vol[:, : shape[1] // 2] = (rng.random((shape[0], shape[1] // 2, shape[2])) * 900
                               + 100).astype(np.uint16)
    return vol


def _forward_batches(vol, n):
    """Forward batches of BATCH windows the n-way sharding runs, summed
    over shards (each shard batches its own active windows)."""
    interval = scan_interval(vol.shape, ROI, 0.5)
    _, zloc, _, shard_z = plan_sharding(vol.shape[0], ROI[0], interval[0], n)
    ys, xs = (_dim_starts(vol.shape[d], ROI[d], interval[d]) for d in (1, 2))
    total = 0
    for k, zs in enumerate(shard_z):
        active = sum(1 for z in zs for y in ys for x in xs
                     if vol[k * zloc + z:k * zloc + z + ROI[0], y:y + ROI[1],
                            x:x + ROI[2]].max() > 0)
        total += math.ceil(active / BATCH)
    return total


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_fast_inference_on_one_card(dev, n):
    """Full width, fast mode: mean logits within rtol = atol = 1e-4 of the
    single-device run, and every shard's forwards on the kernels: 18
    conv3d_cs (17 packed, none on the wide instance, 1 direct), 17 conv3d_cs_pack and 4
    deconv2x_cs launches per forward batch, summed over shards."""
    mcfg = BasicUNetConfig(precision="fast")
    model = build_model(init_state_dict(mcfg, torch.Generator().manual_seed(0)), mcfg, dev)
    vol = _volume()
    cfg = SlidingWindowConfig(roi=ROI, batch_size=BATCH)
    want, _ = infer_volume(model, vol, cfg, mcfg, return_binary=False)
    conv3d_cs.launches = conv3d_cs_packed.launches = conv3d_cs_direct.launches = 0
    conv3d_cs_packed.wide_launches = conv3d_cs_pack.launches = deconv2x_cs.launches = 0
    got = sharded_infer_volume(make_mesh({"sp": n}, devices=[dev] * n), model, vol, cfg, mcfg)
    nb = _forward_batches(vol, n)
    assert nb > 0
    assert (conv3d_cs.launches, conv3d_cs_packed.launches, conv3d_cs_direct.launches,
            conv3d_cs_packed.wide_launches, conv3d_cs_pack.launches, deconv2x_cs.launches) == (
        18 * nb, 17 * nb, nb, 0, 17 * nb, 4 * nb)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_parity_tta_flips_on_one_card(dev):
    mcfg = BasicUNetConfig(features=(4, 4, 8, 16, 32, 4))
    model = build_model(init_state_dict(mcfg, torch.Generator().manual_seed(1)), mcfg, dev)
    vol = _volume((70, 32, 48))
    cfg = SlidingWindowConfig(roi=(16, 16, 16), batch_size=4, tta=True, tta_noise_std=0.0)
    want, _ = infer_volume(model, vol, cfg, mcfg, return_binary=False)
    got = sharded_infer_volume(make_mesh({"sp": 4}, devices=[dev] * 4), model, vol, cfg, mcfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_labeler_on_the_card(dev):
    rng = np.random.default_rng(42)
    vol = (rng.random((256, 48, 40)) > 0.72).astype(np.uint8)
    for x in range(0, 40, 7):
        vol[:, 11, x] = 1
    want, want_n = label_volume_host(vol)
    got, n = label_volume_sharded(make_mesh({"sp": 4}, devices=[dev] * 4), vol)
    assert n == want_n
    np.testing.assert_array_equal(got, want)


def test_sharded_over_distinct_cards(dev):
    """Every visible card one shard (skips with fewer than two): replicas
    on the other cards launch the same kernels, halo planes cross between
    cards, and the result equals one card's."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    mcfg = BasicUNetConfig(precision="fast")
    model = build_model(init_state_dict(mcfg, torch.Generator().manual_seed(0)), mcfg, dev)
    vol = _volume((96 * n, 192, 128))  # every shard holds a window start
    cfg = SlidingWindowConfig(roi=ROI, batch_size=BATCH)
    want, _ = infer_volume(model, vol, cfg, mcfg, return_binary=False)
    conv3d_cs.launches = deconv2x_cs.launches = 0
    mesh = make_mesh()
    assert len({str(d) for d in mesh.devices.flat}) == n
    got = sharded_infer_volume(mesh, model, vol, cfg, mcfg)
    nb = _forward_batches(vol, n)
    assert (conv3d_cs.launches, deconv2x_cs.launches) == (18 * nb, 4 * nb)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    binary = (np.random.default_rng(3).random((64 * n, 48, 40)) > 0.72).astype(np.uint8)
    labels, count = label_volume_sharded(mesh, binary)
    want_labels, want_n = label_volume_host(binary)
    assert count == want_n
    np.testing.assert_array_equal(labels, want_labels)
