"""The port's BasicUNet (parity and fast) and weight loading against the JAX
package, on the same weights and numpy inputs.

Parity: f32 both sides, rtol = atol = 2e-4 (the bounds of
tests/test_basic_unet.py). Fast: bf16 activations on both sides with other
rounding points (the port sends every conv through its kernel, JAX only the
large planes), so the relative bound of tests/test_pallas_kernels.py:297-321:
max |diff| < 0.5 · (mean |JAX logit| + 1e-3)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from delivr_cfos_tpu.models.basic_unet import (
    BasicUNetConfig as JaxConfig,
    basic_unet_apply as jax_apply,
    init_params,
    param_count,
)
from delivr_cfos_tpu.models.convert import save_params_npz
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNet,
    BasicUNetConfig,
    basic_unet_apply,
    build_model,
    infer_model_config,
    init_state_dict,
)
from delivr_cfos_tpu_torch.models.basic_unet_cs import apply_cs
from delivr_cfos_tpu_torch.models.convert import (
    load_weights,
    state_dict_from_jax_params,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)


def _jax_params(seed, features=TINY):
    """A JAX param pytree (numpy leaves) in init_params' layout, drawn with
    numpy; the InstanceNorm affine is randomized too."""
    rng = np.random.default_rng(seed)
    f = features

    def u(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def block(cin, cout):
        return {
            "w": u((3, 3, 3, cin, cout), (3.0 / (27 * cin)) ** 0.5),
            "b": u((cout,), (1.0 / (27 * cin)) ** 0.5),
            "scale": rng.uniform(0.75, 1.25, cout).astype(np.float32),
            "bias": rng.normal(0, 0.1, cout).astype(np.float32),
        }

    def two(cin, cmid, cout):
        return {"conv_0": block(cin, cmid), "conv_1": block(cmid, cout)}

    def up(cin, cup, cskip, cout):
        p = two(cskip + cup, cout, cout)
        p["deconv_w"] = u((cin, cup, 2, 2, 2), (1.0 / (8 * cin)) ** 0.5)
        p["deconv_b"] = u((cup,), (1.0 / (8 * cin)) ** 0.5)
        return p

    return {
        "conv_0": two(1, f[0], f[0]),
        "down_1": two(f[0], f[1], f[1]),
        "down_2": two(f[1], f[2], f[2]),
        "down_3": two(f[2], f[3], f[3]),
        "down_4": two(f[3], f[4], f[4]),
        "upcat_4": up(f[4], f[3], f[3], f[3]),
        "upcat_3": up(f[3], f[2], f[2], f[2]),
        "upcat_2": up(f[2], f[1], f[1], f[1]),
        "upcat_1": up(f[1], f[1], f[0], f[5]),
        "final": {"w": u((1, 1, 1, f[5], 1), f[5] ** -0.5), "b": u((1,), 0.1)},
    }


@pytest.fixture(scope="module")
def params():
    return _jax_params(0)


def _port_model(params):
    sd = state_dict_from_jax_params(params)
    return build_model(sd, infer_model_config(sd), "cpu")


@pytest.mark.parametrize("shape", [(32, 32, 16), (35, 37, 18)])
def test_parity_forward_matches_jax(params, shape):
    """Even and odd shapes; odd ones exercise the UpCat replicate pad."""
    x = (np.random.default_rng(1).random((1, *shape, 1)) * 1000).astype(np.float32)
    want = np.asarray(jax_apply(params, jnp.asarray(x), JaxConfig(features=TINY)))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fast_forward_matches_jax_apply_cs(params):
    x = np.random.default_rng(0).random((1, 16, 32, 32, 1)).astype(np.float32)
    want = np.asarray(
        jax_apply(params, jnp.asarray(x),
                  JaxConfig.fast(features=TINY, conv_impl="pallas_cs")),
        np.float32,
    )
    model = _port_model(params)
    got = apply_cs(model, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = np.abs(got.float().numpy() - want)
    scale = np.abs(want).mean() + 1e-3
    assert diff.max() / scale < 0.5, (diff.max(), scale)
    # and through the mode switch
    fast = basic_unet_apply(model, torch.from_numpy(x),
                            BasicUNetConfig(features=TINY, precision="fast"))
    np.testing.assert_array_equal(fast.float().numpy(), got.float().numpy())


def test_fast_forward_rejects_windows_not_divisible_by_16(params):
    with pytest.raises(ValueError):
        apply_cs(_port_model(params), torch.zeros(1, 16, 24, 16, 1))


@pytest.mark.parametrize("layout", ["state_dict+module", "model_state", "bare"])
def test_load_weights_tar_variants(params, tmp_path, layout):
    sd = state_dict_from_jax_params(params)  # MONAI keys, torch tensors
    if layout == "state_dict+module":
        ckpt = {"state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3}
    elif layout == "model_state":
        ckpt = {"model_state": sd}
    else:
        ckpt = sd
    path = str(tmp_path / "weights.tar")
    torch.save(ckpt, path)
    loaded = load_weights(path)
    assert set(loaded) == set(sd)
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)


def test_load_weights_jax_npz_drives_both_packages(params, tmp_path):
    path = str(tmp_path / "w.npz")
    save_params_npz(path, params)
    sd = load_weights(path)
    cfg = infer_model_config(sd)
    assert cfg.features == TINY and cfg.in_channels == 1 and cfg.out_channels == 1
    x = np.random.default_rng(2).random((1, 16, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jax_apply(params, jnp.asarray(x), JaxConfig(features=TINY)))
    with torch.no_grad():
        got = build_model(sd, cfg, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_state_dict_keys_match_monai_topology():
    """Key names and shapes as tests/torch_basicunet.py pins them."""
    from torch_basicunet import TorchBasicUNet

    ref = TorchBasicUNet(features=TINY).state_dict()
    ours = BasicUNet(BasicUNetConfig(features=TINY)).state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref.items()
    }


def test_full_size_param_count_and_seeded_init():
    model = BasicUNet()
    n = sum(p.numel() for p in model.parameters())
    # shapes only: tracing init_params costs no random draws
    assert n == param_count(jax.eval_shape(init_params, jax.random.PRNGKey(0)))
    a = init_state_dict(BasicUNetConfig(), torch.Generator().manual_seed(5))
    b = init_state_dict(BasicUNetConfig(), torch.Generator().manual_seed(5))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a) == set(model.state_dict())
