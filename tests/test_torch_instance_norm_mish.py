"""The port's InstanceNorm+mish op and the model paths that run it, against
the JAX package on the same numpy inputs and weights.

- the op's plain version against the Pallas kernel ``instance_norm_mish_
  pallas`` in interpret mode, at the shapes of tests/test_pallas_kernels.py
  plus odd and one-voxel planes: f32 within rtol 1e-4, atol 1e-5 (that
  file's bound); bf16 input within one bf16 ULP (rtol 2⁻⁷), since sums in
  another order may move the one rounding to bf16;
- the ``fused_in_mish=True`` parity forward against JAX's at rtol = atol =
  2e-4 (the bound of tests/test_basic_unet.py);
- fast mode on a window whose dims do not divide by 16: the port's bf16
  forward against JAX's bf16 ``_apply`` fallback, under the bound of
  tests/test_torch_unet.py for bf16 paths with other rounding points.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from delivr_cfos_tpu.models.basic_unet import (
    BasicUNetConfig as JaxConfig,
    basic_unet_apply as jax_apply,
)
from delivr_cfos_tpu.ops.pallas.fused_norm_mish import instance_norm_mish_pallas
from delivr_cfos_tpu_torch.models import basic_unet
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    basic_unet_apply,
    build_model,
    infer_model_config,
)
from delivr_cfos_tpu_torch.models.convert import state_dict_from_jax_params
from delivr_cfos_tpu_torch.ops.instance_norm_mish import (
    instance_norm_mish,
    instance_norm_mish_reference,
)
from test_torch_unet import TINY, _jax_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _inputs(shape, seed, std=3.0):
    """(N, D, H, W, C) numpy x and (C,) scale, bias."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, std, shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 0.2, shape[-1]).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, dtype=torch.float32):
    """The port's op on the NDHWC numpy input, returned as NDHWC f32."""
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous().to(dtype)
    out = instance_norm_mish(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert out.dtype == dtype and out.shape == xt.shape
    return out.float().permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("shape", [
    (1, 8, 8, 8, 16), (2, 4, 8, 16, 32),  # tests/test_pallas_kernels.py:11
    (1, 3, 5, 7, 8),  # odd spatial dims
    (2, 1, 1, 1, 8),  # one-voxel planes: variance 0
    (1, 6, 6, 4, 256),  # level 4 of a 96x96x64 window
])
def test_plain_version_matches_pallas_f32(shape):
    x, scale, bias = _inputs(shape, seed=sum(shape))
    want = np.asarray(instance_norm_mish_pallas(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), interpret=True))
    got = _port(x, scale, bias)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4, 8, 16, 32), (1, 3, 5, 7, 8), (2, 1, 1, 1, 8)])
def test_plain_version_matches_pallas_bf16(shape):
    x, scale, bias = _inputs(shape, seed=sum(shape) + 1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = instance_norm_mish_pallas(xb, jnp.asarray(scale), jnp.asarray(bias),
                                     interpret=True)
    assert want.dtype == jnp.bfloat16
    # both sides from the same bf16 input values
    got = _port(np.asarray(xb, np.float32), scale, bias, torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=2.0**-7, atol=1e-5)


def test_one_voxel_plane_gives_mish_of_the_bias():
    """var = Σx²/S − mean² is exactly 0 for S = 1, so y = bias (no NaN)."""
    x = torch.tensor([[[[[1e3]]], [[[-7.25]]]]])  # (1, 2, 1, 1, 1)
    bias = torch.tensor([0.3, -1.5])
    out = instance_norm_mish(x, torch.tensor([2.0, 0.5]), bias)
    want = bias * torch.tanh(torch.nn.functional.softplus(bias))
    torch.testing.assert_close(out.reshape(2), want, rtol=1e-6, atol=1e-7)


def test_wrapper_raises_off_cuda_and_cpu():
    x = torch.zeros(1, 2, 2, 2, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        instance_norm_mish(x, torch.ones(2, device="meta"), torch.zeros(2, device="meta"))


def test_plain_version_is_the_formula_not_the_two_pass_variance():
    """E[x²] − mean² on a plane with a large mean (the TPU kernel's form)."""
    x = torch.tensor([1000.0, 1000.5, 1001.0, 999.5]).reshape(1, 1, 1, 1, 4)
    s1, s2 = x.sum(), (x * x).sum()
    mean = s1 / 4
    var = s2 / 4 - mean * mean
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    want = y * torch.tanh(torch.nn.functional.softplus(y))
    got = instance_norm_mish_reference(x, torch.ones(1), torch.zeros(1))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def params():
    return _jax_params(4)


def _port_model(params):
    sd = state_dict_from_jax_params(params)
    return build_model(sd, infer_model_config(sd), "cpu")


def test_fused_flag_routes_every_epilogue_through_the_op(params, monkeypatch):
    calls = []

    def counting(x, scale, bias):
        calls.append(tuple(x.shape))
        return instance_norm_mish(x, scale, bias)

    monkeypatch.setattr(basic_unet, "instance_norm_mish", counting)
    model = _port_model(params)
    x = torch.from_numpy(np.random.default_rng(5).random((1, 16, 16, 16, 1), np.float32))
    with torch.no_grad():
        plain = basic_unet_apply(model, x, BasicUNetConfig(features=TINY))
        assert not calls
        fused = basic_unet_apply(model, x, BasicUNetConfig(features=TINY, fused_in_mish=True))
        assert len(calls) == 18
        x_odd = torch.cat([x, x[:, :, :8]], dim=2)  # 16×24×16: not /16
        fast = basic_unet_apply(model, x_odd, BasicUNetConfig(
            features=TINY, precision="fast", fused_in_mish=True))
    assert len(calls) == 36 and fast.dtype == torch.bfloat16
    torch.testing.assert_close(fused, plain, rtol=2e-5, atol=2e-5)


def test_fused_parity_forward_matches_jax(params):
    x = (np.random.default_rng(6).random((1, 16, 16, 16, 1)) * 1000).astype(np.float32)
    want = np.asarray(jax_apply(params, jnp.asarray(x),
                                JaxConfig(features=TINY, fused_in_mish=True)))
    with torch.no_grad():
        got = basic_unet_apply(_port_model(params), torch.from_numpy(x),
                               BasicUNetConfig(features=TINY, fused_in_mish=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_fast_mode_falls_back_to_bf16_forward_like_jax(params, fused):
    """16×24×16 does not divide by 16: JAX's pallas_cs fast mode runs its
    bf16 ``_apply``; the port's fast mode runs its bf16 forward instead of
    raising."""
    x = np.random.default_rng(7).random((1, 16, 24, 16, 1)).astype(np.float32)
    want = np.asarray(
        jax_apply(params, jnp.asarray(x), JaxConfig.fast(
            features=TINY, conv_impl="pallas_cs", fused_in_mish=fused)),
        np.float32,
    )
    with torch.no_grad():
        got = basic_unet_apply(_port_model(params), torch.from_numpy(x),
                               BasicUNetConfig(features=TINY, precision="fast",
                                               fused_in_mish=fused))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = np.abs(got.float().numpy() - want)
    scale = np.abs(want).mean() + 1e-3
    assert diff.max() / scale < 0.5, (diff.max(), scale)
