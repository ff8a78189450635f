"""The port's conv3d_cs (plain version on the CPU) against the JAX package's
Pallas conv3d_cs in interpret mode, on the same numpy inputs.

Tolerances: outputs within one bf16 ULP at their magnitude — both sides sum
the same bf16 products in f32, in other orders, and round once, so a sum
near a rounding boundary may land one step apart (tests/test_pallas_kernels.py
argues the same bound). Stats within rtol 1e-3 of the f32 sums."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from delivr_cfos_tpu.ops.pallas.conv3d_cs import conv3d_cs as jax_conv3d_cs
from delivr_cfos_tpu_torch.ops.conv3d_cs import conv3d_cs, conv3d_cs_reference
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, D, H, W = 2, 5, 6, 8


def _bf16_ulp(v):
    """One bf16 ULP at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), 2.0**-100)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_within_one_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    diff = np.abs(got - want)
    assert (diff <= bound).all(), float((diff / bound).max())


def assert_stats_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max()
    )


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _bf16(a):
    return _t(a).to(torch.bfloat16)


def _np(t):
    return t.float().numpy()


def _inputs(rng, cin, cout):
    x = rng.standard_normal((B, D, cin, H * W)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("cin,cout", [(4, 6), (2, 2)])
def test_matches_jax_with_bias(cin, cout):
    x, w, b = _inputs(np.random.default_rng(0), cin, cout)
    want = jax_conv3d_cs(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         h=H, w=W, interpret=True)
    got = conv3d_cs(_bf16(x), _t(w), _t(b), h=H, w=W)
    assert got.dtype == torch.bfloat16
    assert_within_one_ulp(_np(got), want)


@pytest.mark.parametrize("cin", [1, 3])
def test_odd_cin_unpadded_matches_jax_padded(cin):
    """The port takes odd C_in as it is; JAX gets a zero channel appended
    (what its model path does before calling the kernel)."""
    x, w, b = _inputs(np.random.default_rng(cin), cin, 4)
    xp = np.concatenate([x, np.zeros((B, D, 1, H * W), np.float32)], axis=2)
    wp = np.concatenate([w, np.zeros((3, 3, 3, 1, 4), np.float32)], axis=3)
    want, st_want = jax_conv3d_cs(jnp.asarray(xp), jnp.asarray(wp), None,
                                  h=H, w=W, interpret=True, emit_stats=True)
    got, st = conv3d_cs(_bf16(x), _t(w), None, h=H, w=W, emit_stats=True)
    assert_within_one_ulp(_np(got), want)
    assert_stats_close(st.numpy(), st_want)


def test_no_bias_and_stats():
    x, w, _ = _inputs(np.random.default_rng(3), 4, 6)
    want, st_want = jax_conv3d_cs(jnp.asarray(x), jnp.asarray(w), None,
                                  h=H, w=W, interpret=True, emit_stats=True)
    got, st = conv3d_cs(_bf16(x), _t(w), None, h=H, w=W, emit_stats=True)
    assert st.shape == (B, D, 2, 6) and st.dtype == torch.float32
    assert_within_one_ulp(_np(got), want)
    assert_stats_close(st.numpy(), st_want)
    # the stats are of the f32 output: they match the rounded output's sums
    # only to bf16 level
    y = _np(got)
    np.testing.assert_allclose(st.numpy()[:, :, 0], y.sum(3), rtol=3e-2, atol=3e-2)


def test_pair_mode_with_bias2():
    rng = np.random.default_rng(7)
    c1, c2, cout = 2, 6, 8
    x1 = rng.standard_normal((B, D, c1, H * W)).astype(np.float32)
    x2 = rng.standard_normal((B, D, c2, H * W)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, c1 + c2, cout)).astype(np.float32) * 0.2
    b2 = rng.standard_normal(c2).astype(np.float32)
    want, st_want = jax_conv3d_cs(
        jnp.asarray(x1, jnp.bfloat16), jnp.asarray(w[:, :, :, :c1]), None,
        h=H, w=W, interpret=True, emit_stats=True,
        pair=(jnp.asarray(x2, jnp.bfloat16), jnp.asarray(w[:, :, :, c1:]),
              jnp.asarray(b2)),
    )
    got, st = conv3d_cs(
        _bf16(x1), _t(w[:, :, :, :c1]), None, h=H, w=W, emit_stats=True,
        pair=(_bf16(x2), _t(w[:, :, :, c1:]), _t(b2)),
    )
    assert_within_one_ulp(_np(got), want)
    assert_stats_close(st.numpy(), st_want)
    # pair mode is the conv of the concat with the bias folded into x2
    x2b = (_bf16(x2).float() + _bf16(b2).float()[None, None, :, None]).to(torch.bfloat16)
    cat = conv3d_cs(torch.cat([_bf16(x1), x2b], dim=2), _t(w), None, h=H, w=W)
    np.testing.assert_array_equal(_np(got), _np(cat))


def test_in_affine_prologue():
    rng = np.random.default_rng(0)
    x, w, b = _inputs(rng, 4, 6)
    a = rng.uniform(0.5, 1.5, (B, 4)).astype(np.float32)
    c = rng.normal(0, 0.3, (B, 4)).astype(np.float32)
    want = jax_conv3d_cs(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         h=H, w=W, interpret=True,
                         in_affine=(jnp.asarray(a), jnp.asarray(c)))
    got = conv3d_cs(_bf16(x), _t(w), _t(b), h=H, w=W, in_affine=(_t(a), _t(c)))
    assert_within_one_ulp(_np(got), want)
    with pytest.raises(ValueError):
        conv3d_cs(_bf16(x), _t(w), None, h=H, w=W, in_affine=(_t(a), _t(c)),
                  pair=(_bf16(x), _t(w)))


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, w, b = _inputs(np.random.default_rng(1), 2, 2)
    before = conv3d_cs.launches
    got = conv3d_cs(_bf16(x), _t(w), _t(b), h=H, w=W)
    want = conv3d_cs_reference(_bf16(x), _t(w), _t(b), h=H, w=W)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert conv3d_cs.launches == before
    with pytest.raises(ValueError):
        conv3d_cs(_bf16(x).to("meta"), _t(w), _t(b), h=H, w=W)


def test_build_paths_are_keyed_by_source():
    from delivr_cfos_tpu_torch.ops import _build

    path = _build.library_path("conv3d_cs")
    assert path.startswith(_build.BUILD_ROOT)
    assert path.endswith("libconv3d_cs.so")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
