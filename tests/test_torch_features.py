"""The port's feature bank (ops/features.py) against the JAX package's on the
same seeded volumes, and the eigenvalues against numpy.

The port filters by sums of shifted slices, the JAX package by XLA
convolutions: sums in another order. So every channel is held to 2e-6 of
the largest magnitude in the feature stack (float32 carries about 6e-8 per
rounding; a 29-tap filter over three axes adds a few hundred, and a
difference of Gaussians cancels them against each other), the eigenvalue
features to 1e-4 of it (the middle eigenvalue is 3q − e1 − e3, and arccos
near ±1 magnifies the input's rounding). Eigenvalues against
np.linalg.eigvalsh: atol 1e-4, as tests/test_ilastik_import.py holds the
JAX ones."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delivr_cfos_tpu.ops import features as jf
from delivr_cfos_tpu_torch.ops.features import (
    ILASTIK_FEATURE_IDS,
    _deriv_conv,
    _eigvals_sym3,
    _reflect_index,
    _sep_conv,
    feature_bank,
    ilastik_feature_bank,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _stack(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 255).astype(np.uint8)


def _assert_channels_close(ours, theirs, rel):
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    scale = float(np.abs(theirs).max())
    for c in range(ours.shape[-1]):
        err = float(np.abs(ours[..., c] - theirs[..., c]).max())
        assert err <= rel * scale, (c, err, scale)


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("r", [3, 14])
def test_reflect_index_is_numpy_reflect(n, r):
    """numpy's rule (the edge is not repeated), reflecting again where the
    pad reaches past the other edge, as jnp.pad does."""
    want = np.pad(np.arange(n), r, mode="reflect")
    np.testing.assert_array_equal(_reflect_index(n, r, "cpu").numpy(), want)


@pytest.mark.parametrize("shape", [(12, 20, 16), (3, 5, 4)])
def test_feature_bank_close_to_jax(shape):
    """The default bank (σ 0.7, 1.6, 3.5: radius up to 14) on a volume and on
    one smaller than the radius on every axis (reflect past the edge)."""
    vol = _stack(shape, 0)
    ours = feature_bank(torch.from_numpy(vol)).numpy()
    theirs = np.asarray(jf.feature_bank(jnp.asarray(vol)))
    assert ours.shape == (*shape, 12)
    _assert_channels_close(ours, theirs, 2e-6)


@pytest.mark.parametrize("fid", ILASTIK_FEATURE_IDS)
def test_ilastik_feature_close_to_jax(fid):
    vol = _stack((10, 14, 12), 1)
    spec = ((fid, 0.7), (fid, 1.6))
    ours = ilastik_feature_bank(torch.from_numpy(vol), spec).numpy()
    theirs = np.asarray(jf.ilastik_feature_bank(jnp.asarray(vol), spec))
    rel = 1e-4 if fid.endswith("Eigenvalues") else 2e-6
    _assert_channels_close(ours, theirs, rel)


def test_ilastik_feature_bank_rejects_an_unknown_id():
    with pytest.raises(ValueError, match="unknown Ilastik feature id"):
        ilastik_feature_bank(torch.zeros(2, 2, 2), (("Sobel", 1.0),))


def test_sep_conv_close_to_jax_per_derivative():
    vol = _stack((9, 11, 13), 2).astype(np.float32)
    for orders in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 2), (1, 1, 0)):
        ours = _deriv_conv(torch.from_numpy(vol), 1.2, orders).numpy()
        theirs = np.asarray(jf._deriv_conv(jnp.asarray(vol), 1.2, orders))
        _assert_channels_close(ours[..., None], theirs[..., None], 2e-6)
    # an axis skipped with None is left as it is
    g = jf._gauss_kernel(0.7)
    ours = _sep_conv(torch.from_numpy(vol), (None, g, None)).numpy()
    theirs = np.asarray(jf._sep_conv(jnp.asarray(vol), (None, g, None)))
    _assert_channels_close(ours[..., None], theirs[..., None], 2e-6)


def test_eigenvalue_features_match_numpy():
    """Hessian eigenvalues agree with np.linalg.eigvalsh (descending)."""
    rng = np.random.default_rng(3)
    vol = torch.from_numpy(rng.random((8, 10, 12)).astype(np.float32)) * 10
    s = 1.2
    h = [_deriv_conv(vol, s, o) for o in
         ((2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1))]
    e1, e2, e3 = (e.numpy() for e in _eigvals_sym3(*h))
    zz, yy, xx, zy, zx, yx = (t.numpy() for t in h)
    H = np.zeros((*vol.shape, 3, 3))
    H[..., 0, 0], H[..., 1, 1], H[..., 2, 2] = zz, yy, xx
    H[..., 0, 1] = H[..., 1, 0] = zy
    H[..., 0, 2] = H[..., 2, 0] = zx
    H[..., 1, 2] = H[..., 2, 1] = yx
    ev = np.linalg.eigvalsh(H)  # ascending
    np.testing.assert_allclose(e1, ev[..., 2], atol=1e-4)
    np.testing.assert_allclose(e2, ev[..., 1], atol=1e-4)
    np.testing.assert_allclose(e3, ev[..., 0], atol=1e-4)


def test_eigenvalues_of_a_degenerate_field_are_the_mean():
    """p² < 1e-20 (a multiple of the identity): every eigenvalue is q."""
    a = torch.full((4,), 2.5)
    z = torch.zeros(4)
    for e in _eigvals_sym3(a, a, a, z, z, z):
        np.testing.assert_array_equal(e.numpy(), np.full(4, 2.5, np.float32))
