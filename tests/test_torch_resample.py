"""The port's resampling ops (ops/resample.py) against
tests/test_resample.py's checks and against the JAX package's ops on the
same seeded inputs.

Tolerances:
- block-mean downsample, truncated to uint16 as stage 1 does: equal to JAX
  where every partial block sum stays below 2^24 (all sums are exact
  integers on both sides); within 1 count at the full uint16 range, where
  the JAX float32 sum rounds in its own order (the count that differs is
  printed);
- trilinear zoom in float32: within 3e-7 of JAX on values in [0, 1] (XLA on
  the CPU contracts ``a·(1−w) + b·w`` into a fused multiply-add; the port
  rounds each operation, so the two differ in the last bit);
- the uint8 mask zoom and the 8-bit contrast stretch: equal to JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.ndimage import zoom as scipy_zoom

from delivr_cfos_tpu.ops import resample as jr
from delivr_cfos_tpu_torch.ops.resample import (
    block_mean_downsample,
    contrast_stretch_8bit,
    trilinear_zoom,
    zoom_mask_to,
)
from delivr_cfos_tpu_torch.utils.device import upload
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _down_u16(vol, factors):
    return block_mean_downsample(upload(vol, "cpu"), factors).numpy().astype(np.uint16)


def _jax_down_u16(vol, factors):
    return np.asarray(jr.block_mean_downsample(jnp.asarray(vol), factors)).astype(np.uint16)


# ---- tests/test_resample.py, on the port ---------------------------------


def test_block_mean_matches_skimage_semantics():
    """downscale_local_mean zero-pads to a multiple and includes pad in mean."""
    rng = np.random.default_rng(0)
    vol = (rng.random((10, 31, 17)) * 60000).astype(np.uint16)
    factors = (4, 15, 15)
    out = block_mean_downsample(upload(vol, "cpu"), factors).numpy()
    padded = np.zeros((12, 45, 30), np.float64)
    padded[:10, :31, :17] = vol
    expected = padded.reshape(3, 4, 3, 15, 2, 15).mean(axis=(1, 3, 5))
    np.testing.assert_allclose(out, expected, rtol=1e-5)


def test_trilinear_zoom_matches_scipy_order1():
    rng = np.random.default_rng(1)
    vol = rng.random((7, 9, 5)).astype(np.float32)
    out_shape = (21, 27, 15)
    ours = trilinear_zoom(torch.from_numpy(vol), out_shape).numpy()
    ref = scipy_zoom(vol, (3, 3, 3), order=1, prefilter=False, grid_mode=False)
    assert ref.shape == out_shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_trilinear_zoom_noninteger_factors():
    rng = np.random.default_rng(2)
    vol = rng.random((10, 8, 6)).astype(np.float32)
    out_shape = (23, 19, 17)
    ours = trilinear_zoom(torch.from_numpy(vol), out_shape).numpy()
    ref = scipy_zoom(
        vol, (23 / 10, 19 / 8, 17 / 6), order=1, prefilter=False, grid_mode=False
    )
    assert ref.shape == out_shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_zoom_mask_chunked_equals_unchunked():
    rng = np.random.default_rng(3)
    mask = (rng.random((6, 10, 8)) > 0.5).astype(np.uint8)
    out_shape = (25, 40, 32)
    chunked = zoom_mask_to(mask, out_shape, chunk_z=7, device="cpu")
    ref = scipy_zoom(
        mask.astype(np.float32),
        (25 / 6, 40 / 10, 32 / 8),
        order=1,
        prefilter=False,
        grid_mode=False,
    ).astype(np.uint8)
    np.testing.assert_array_equal(chunked, ref)


def test_contrast_stretch_matches_reference_formula():
    rng = np.random.default_rng(4)
    stack = (rng.random((4, 32, 32)) * 50000).astype(np.uint16)
    ours = contrast_stretch_8bit(upload(stack, "cpu")).numpy()
    s = stack.astype(np.float64)
    minval = round(np.percentile(s.ravel(), 1))
    maxval = round(np.percentile(s.ravel(), 99))
    s = np.clip(s, minval, maxval)
    eq16 = ((s - minval) / (maxval - minval) * 65534).astype(np.uint16)
    expected = (eq16 >> 8).astype(np.uint8)
    # percentile interpolation may differ by ±1 grayvalue at the cutoffs
    assert np.abs(ours.astype(int) - expected.astype(int)).max() <= 1


# ---- the port against the JAX package -------------------------------------


@pytest.mark.parametrize("shape,factors", [
    ((8, 64, 48), (2, 4, 4)),  # tests/test_stage01_ingest.py's ratios
    ((9, 33, 47), (4, 15, 15)),  # the default ratios, ragged y and x
])
def test_block_mean_equals_jax_below_2_24(shape, factors):
    """Values up to 60000 in blocks of ≤ 16 voxels (sums < 2^20), or up to
    18000 in blocks of 900 (sums < 2^24): every sum is exact, and the mean
    is the sum times the float32 reciprocal of the block size on both sides,
    so the float32 and the uint16 results are equal."""
    rng = np.random.default_rng(5)
    top = 60000 if np.prod(factors) <= 16 else 18000
    vol = (rng.random(shape) * top).astype(np.uint16)
    vol[1, :8, :8] = top
    ours = block_mean_downsample(upload(vol, "cpu"), factors).numpy()
    theirs = np.asarray(jr.block_mean_downsample(jnp.asarray(vol), factors))
    np.testing.assert_array_equal(ours, theirs)  # float32, before the cast
    np.testing.assert_array_equal(_down_u16(vol, factors), _jax_down_u16(vol, factors))


def test_block_mean_full_uint16_range_within_one_count():
    """Blocks of 900 voxels near 65535 sum to about 5.9e7 > 2^24: the JAX
    float32 sum rounds in its order, the port sums exactly. Truncated to
    uint16 the two may differ by one count."""
    rng = np.random.default_rng(6)
    vol = (65535 - rng.random((16, 90, 105)) * 2000).astype(np.uint16)
    ours, theirs = _down_u16(vol, (4, 15, 15)), _jax_down_u16(vol, (4, 15, 15))
    diff = np.abs(ours.astype(np.int64) - theirs)
    print(f"voxels that differ by one count: {int((diff > 0).sum())} of {diff.size}")
    assert diff.max() <= 1
    # the port's value is the exact mean, truncated
    exact = vol.reshape(4, 4, 6, 15, 7, 15).astype(np.int64).sum(axis=(1, 3, 5))
    np.testing.assert_array_equal(
        ours, (exact.astype(np.float32) * (np.float32(1) / np.float32(900))).astype(np.uint16))


@pytest.mark.parametrize("shape,out_shape", [
    ((7, 9, 5), (21, 27, 15)),
    ((10, 8, 6), (23, 19, 17)),
    ((4, 6, 5), (4, 30, 2)),  # an axis kept, one shrunk
])
def test_trilinear_zoom_close_to_jax(shape, out_shape):
    rng = np.random.default_rng(7)
    vol = rng.random(shape).astype(np.float32)
    ours = trilinear_zoom(torch.from_numpy(vol), out_shape).numpy()
    theirs = np.asarray(jr.trilinear_zoom(jnp.asarray(vol), out_shape))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=3e-7)


@pytest.mark.parametrize("shape,out_shape,chunk_z", [
    ((6, 10, 8), (25, 40, 32), 7),
    ((4, 16, 12), (10, 64, 48), 64),  # stage 1's brain in tests/test_stage01_ingest.py
    ((12, 9, 11), (100, 37, 41), 16),
])
def test_zoom_mask_equals_jax(shape, out_shape, chunk_z):
    """The uint8 mask is what stage 1 keeps: only values that round to
    exactly 1.0 become mask voxels, and the two agree on every voxel."""
    rng = np.random.default_rng(8)
    mask = (rng.random(shape) > 0.4).astype(np.uint8)
    ours = zoom_mask_to(mask, out_shape, chunk_z=chunk_z, device="cpu")
    theirs = jr.zoom_mask_to(mask, out_shape, chunk_z=chunk_z)
    assert ours.dtype == np.uint8 and ours.sum() > 0
    np.testing.assert_array_equal(ours, theirs)


def test_zoom_mask_into_a_memmap(tmp_path):
    mask = np.zeros((3, 4, 5), np.uint8)
    mask[1:, 1:3, 2:] = 1
    out = np.lib.format.open_memmap(str(tmp_path / "m.npy"), mode="w+",
                                    dtype=np.uint8, shape=(9, 12, 15))
    res = zoom_mask_to(mask, (9, 12, 15), chunk_z=4, out=out, device="cpu")
    assert res is out
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"),
                                  jr.zoom_mask_to(mask, (9, 12, 15), chunk_z=4))
    with pytest.raises(ValueError, match="shape"):
        zoom_mask_to(mask, (9, 12, 16), out=out, device="cpu")


def test_contrast_stretch_equals_jax():
    rng = np.random.default_rng(9)
    stack = (rng.random((6, 40, 36)) * 50000).astype(np.uint16)
    ours = contrast_stretch_8bit(upload(stack, "cpu")).numpy()
    theirs = np.asarray(jr.contrast_stretch_8bit(jnp.asarray(stack)))
    np.testing.assert_array_equal(ours, theirs)


def test_contrast_stretch_above_2_24_voxels():
    """``torch.quantile`` refuses more than 2^24 elements; a downsampled
    brain (324, 400, 467) holds 60 M. Held to the reference formula (±1)."""
    rng = np.random.default_rng(10)
    stack = rng.integers(0, 4000, size=(2**24 + 5000,), dtype=np.uint16)
    ours = contrast_stretch_8bit(upload(stack, "cpu")).numpy()
    s = stack.astype(np.float64)
    minval = round(np.percentile(s, 1))
    maxval = round(np.percentile(s, 99))
    expected = (((np.clip(s, minval, maxval) - minval) / (maxval - minval) * 65534)
                .astype(np.uint16) >> 8).astype(np.uint8)
    assert np.abs(ours.astype(int) - expected.astype(int)).max() <= 1
