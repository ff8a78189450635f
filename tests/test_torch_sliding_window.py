"""The port's sliding-window engine and binarization against the JAX
package's, on the same weights and volumes (parity mode, f32 both sides:
rtol = atol = 1e-4, the engine tests' bound; summation orders differ).

TTA noise cannot match bit for bit (jax.random vs torch.Generator), so
noisy passes are checked for shape and finiteness only."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from scipy.ndimage import binary_erosion

from delivr_cfos_tpu.engine import sliding_window as jsw
from delivr_cfos_tpu.models.basic_unet import BasicUNetConfig as JaxConfig
from delivr_cfos_tpu.models.convert import torch_state_dict_to_params
from delivr_cfos_tpu.ops.morphology import binarize_logits as jax_binarize
from delivr_cfos_tpu_torch.engine import sliding_window as sw
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.ops.morphology import (
    binarize_logits,
    binary_erosion_cross,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
ROI = (16, 16, 16)
PORT_CFG = BasicUNetConfig(features=TINY)
JAX_CFG = JaxConfig(features=TINY)


@pytest.fixture(scope="module")
def weights():
    sd = init_state_dict(PORT_CFG, torch.Generator().manual_seed(7))
    return build_model(sd, PORT_CFG, "cpu"), torch_state_dict_to_params(sd)


def _volume(shape, seed=0):
    """Random intensities in the low-y half, zeros in the other."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint16)
    vol[:, : shape[1] // 2] = (
        rng.random((shape[0], shape[1] // 2, shape[2])) * 900 + 40000
    ).astype(np.uint16)  # above 32767: uint16 must not be read as int16
    return vol


def _both(weights, vol, port_cfg, return_binary=True):
    model, params = weights
    jcfg = jsw.SlidingWindowConfig(**dataclasses.asdict(port_cfg))
    want, want_bin = jsw.infer_volume(params, vol, jcfg, JAX_CFG,
                                      return_binary=return_binary)
    got, got_bin = sw.infer_volume(model, vol, port_cfg, PORT_CFG,
                                   return_binary=return_binary)
    return got, got_bin, np.asarray(want), want_bin


# ---------------- grid and plan ----------------


@pytest.mark.parametrize("shape,roi,overlap", [
    ((192, 480, 384), (96, 96, 64), 0.5),
    ((100, 32, 16), (32, 32, 16), 0.5),
    ((192, 300, 128), (96, 96, 64), 0.25),
    ((61, 37, 29), ROI, 0.5),
])
def test_grid_equals_jax(shape, roi, overlap):
    assert sw.scan_interval(shape, roi, overlap) == jsw.scan_interval(shape, roi, overlap)
    np.testing.assert_array_equal(
        sw.dense_patch_starts(shape, roi, overlap),
        jsw.dense_patch_starts(shape, roi, overlap),
    )
    interval = sw.scan_interval(shape, roi, overlap)
    ours = sw._dense_plan_for(shape, roi, interval)
    theirs = jsw._dense_plan_for(shape, roi, interval)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.p == theirs.p
        np.testing.assert_array_equal(ours.regular_mask, theirs.regular_mask)
        assert len(ours.phases) == len(theirs.phases)
        for (o1, m1, w1), (o2, m2, w2) in zip(ours.phases, theirs.phases):
            assert o1 == o2 and m1 == m2
            np.testing.assert_array_equal(w1, w2)


def test_gaussian_importance_equals_jax():
    for roi in (ROI, (96, 96, 64)):
        np.testing.assert_array_equal(
            sw.gaussian_importance_map(roi), jsw.gaussian_importance_map(roi)
        )
        assert sw.gaussian_importance_map(roi).min() >= 1e-3


def test_auto_batch_size_off_cuda_is_a_capped_power_of_two():
    n = sw.auto_batch_size((96, 96, 64), PORT_CFG, 70 * 2**20, device="cpu")
    assert n & (n - 1) == 0 and 1 <= n <= 32


# ---------------- infer_volume against JAX ----------------


@pytest.mark.parametrize("shape,overlap", [((70, 32, 32), 0.5), ((40, 24, 32), 0.4)])
def test_single_pass_matches_jax(weights, shape, overlap):
    """(70, 32, 32) has clamped z tails beside the dense phases; overlap 0.4
    (stride 9, which does not divide 16) runs the per-window path."""
    cfg = sw.SlidingWindowConfig(roi=ROI, overlap=overlap, batch_size=4,
                                 erosion_iters=2)
    got, got_bin, want, want_bin = _both(weights, _volume(shape, 1), cfg)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_bin.numpy(), np.asarray(want_bin))


def test_tta_flips_without_noise_match_jax(weights):
    cfg = sw.SlidingWindowConfig(roi=ROI, batch_size=8, tta=True,
                                 tta_noise_std=0.0)
    got, _, want, _ = _both(weights, _volume((32, 32, 32), 3), cfg,
                            return_binary=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_tta_with_noise_is_finite(weights):
    model, _ = weights
    vol = _volume((32, 32, 16), 4)
    cfg = sw.SlidingWindowConfig(roi=ROI, batch_size=4, tta=True)
    got, _ = sw.infer_volume(model, vol, cfg, PORT_CFG, return_binary=False)
    assert got.shape == vol.shape and torch.isfinite(got).all()
    assert len(sw._tta_passes(cfg)) == 13


def test_gaussian_importance_volume_matches_jax(weights):
    cfg = sw.SlidingWindowConfig(roi=ROI, batch_size=4, importance="gaussian")
    got, _, want, _ = _both(weights, _volume((48, 32, 32), 5), cfg,
                            return_binary=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_background_only_volume(weights):
    model, _ = weights
    vol = np.zeros((32, 32, 16), np.uint16)
    cfg = sw.SlidingWindowConfig(roi=ROI, batch_size=2)
    got, got_bin = sw.infer_volume(model, vol, cfg, PORT_CFG)
    np.testing.assert_allclose(got.numpy(), sw.SKIP_LOGIT)
    assert int(got_bin.max()) == 0


def test_reflect_pad_small_volume_matches_jax(weights):
    cfg = sw.SlidingWindowConfig(roi=ROI, batch_size=2, erosion_iters=1)
    got, got_bin, want, want_bin = _both(weights, _volume((10, 20, 16), 6), cfg)
    assert got.shape == (10, 20, 16) and got_bin.shape == (10, 20, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_bin.numpy(), np.asarray(want_bin))


def test_divide_clamps_int_and_float_counts():
    acc = torch.tensor([2.0, 3.0])
    np.testing.assert_array_equal(
        sw._divide(acc, torch.tensor([0, 2], dtype=torch.int32)).numpy(), [2.0, 1.5]
    )
    out = sw._divide(acc, torch.tensor([0.0, 0.5]))
    assert out[0] == 2.0 / 1e-8 and out[1] == 6.0


# ---------------- morphology ----------------


@pytest.mark.parametrize("iters", [1, 3, 7])
def test_erosion_matches_scipy(iters):
    rng = np.random.default_rng(11)
    mask = (rng.random((24, 30, 18)) > 0.35).astype(np.uint8)
    ours = binary_erosion_cross(torch.from_numpy(mask), iters).numpy()
    ref = binary_erosion(mask, iterations=iters, border_value=1).astype(np.uint8)
    np.testing.assert_array_equal(ours, ref)


def test_binarize_logits_matches_jax():
    rng = np.random.default_rng(12)
    logits = rng.normal(0, 3, (20, 18, 16)).astype(np.float32)
    vol = (rng.random((20, 18, 16)) > 0.2).astype(np.uint16) * 500
    want = np.asarray(jax_binarize(jnp.asarray(logits), jnp.asarray(vol), 0.5, 2))
    got = binarize_logits(torch.from_numpy(logits),
                          torch.from_numpy(vol.astype(np.int32)), 0.5, 2)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
