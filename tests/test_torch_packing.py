"""Window packing (delivr_cfos_tpu_torch/models/packing.py) against the JAX
package's models/packing.py, on the CPU.

Mirrors tests/test_packing.py: the packed block-diagonal model reproduces
the per-window model (zero off-diagonal weights add exact zeros;
InstanceNorm statistics are per channel, so per window), within the JAX
test's 2e-5, and pack then unpack is the identity. Adds: the port's packed
state dict, carried to the JAX layout, equals the JAX ``pack_params`` to the
bit (block copies, no rounding); the packed port model within 2e-4 of the
packed JAX model; and the fast forward (``apply_cs``, the plain versions of
its kernels on the CPU) packed against per-window.

tests/test_packing.py's two ``auto_batch_size`` cases test the JAX engine's
memory telemetry, which the port does not have; the port's own batch rule
is held by
tests/test_torch_sliding_window.py::test_auto_batch_size_off_cuda_is_a_capped_power_of_two."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from delivr_cfos_tpu.models.basic_unet import BasicUNetConfig as JaxConfig
from delivr_cfos_tpu.models.basic_unet import basic_unet_apply as jax_apply
from delivr_cfos_tpu.models.convert import torch_state_dict_to_params
from delivr_cfos_tpu.models.packing import pack_config as jax_pack_config
from delivr_cfos_tpu.models.packing import pack_params as jax_pack_params
from delivr_cfos_tpu.models.packing import pack_windows as jax_pack_windows
from delivr_cfos_tpu.models.packing import unpack_logits as jax_unpack_logits
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    basic_unet_apply,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.models.convert import jax_params_from_state_dict
from delivr_cfos_tpu_torch.models.packing import (
    pack_config,
    pack_params,
    pack_windows,
    unpack_logits,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
CFG = BasicUNetConfig(features=TINY)


@pytest.fixture(scope="module")
def state_dict():
    sd = init_state_dict(CFG, torch.Generator().manual_seed(0))
    # InstanceNorm scale 1 and bias 0 would hide a wrong tiling: draw them
    g = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if ".adn.N." in k:
            sd[k] = torch.rand(v.shape, generator=g) + 0.5 * (k.endswith("weight"))
    return sd


def _windows(n, seed, shape=(16, 16, 16)):
    return np.random.default_rng(seed).random((n, *shape, 1)).astype(np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("G", [2, 4])
def test_pack_params_equals_jax(state_dict, G):
    """Every packed tensor, carried to the JAX layout, equals JAX's to the
    bit: block copies into zeros, and tiles."""
    port = dict(_leaves(jax_params_from_state_dict(pack_params(state_dict, G))))
    ref = dict(_leaves(jax_pack_params(torch_state_dict_to_params(state_dict), G)))
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        assert np.array_equal(port[k], ref[k]), k
    # the packed dict builds the packed config's model
    assert pack_config(CFG, G).features == tuple(f * G for f in TINY)
    assert jax_pack_config(JaxConfig(features=TINY), G).features == pack_config(CFG, G).features
    build_model(pack_params(state_dict, G), pack_config(CFG, G), "cpu")


@pytest.mark.parametrize("G", [2, 4])
def test_packed_model_matches_per_window(state_dict, G):
    """The JAX test's case on the port: parity, within 2e-5."""
    model = build_model(state_dict, CFG, "cpu")
    x = torch.from_numpy(_windows(2 * G, 0))
    with torch.no_grad():
        ref = basic_unet_apply(model, x, CFG)
        pc = pack_config(CFG, G)
        packed = build_model(pack_params(state_dict, G), pc, "cpu")
        got = unpack_logits(basic_unet_apply(packed, pack_windows(x, G), pc), G)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("G", [2, 4])
def test_packed_model_matches_jax_packed_model(state_dict, G):
    """The packed port model against the packed JAX model on the same
    windows and weights: within 2e-4."""
    x = _windows(2 * G, 1)
    pc = pack_config(CFG, G)
    packed = build_model(pack_params(state_dict, G), pc, "cpu")
    with torch.no_grad():
        got = unpack_logits(basic_unet_apply(packed, pack_windows(torch.from_numpy(x), G),
                                             pc), G).numpy()
    jpc = jax_pack_config(JaxConfig(features=TINY), G)
    jp = jax_pack_params(torch_state_dict_to_params(state_dict), G)
    want = np.asarray(jax_unpack_logits(
        jax_apply(jp, jax_pack_windows(jnp.asarray(x), G), jpc), G))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_packed_fast_forward_matches_per_window(state_dict):
    """Fast mode (``apply_cs``) at G = 2, the chip's packing phase at a tiny
    width: the packed first conv takes C_in = 2 and every UpCat's pair-mode
    conv splits its weights at G·c_skip. The packed and per-window runs sum
    their f32 products in another order and round to bf16: within 2 bf16
    ULPs of the largest |logit|."""
    G = 2
    fast = BasicUNetConfig(features=TINY, precision="fast")
    model = build_model(state_dict, fast, "cpu")
    x = torch.from_numpy(_windows(4, 2, shape=(32, 32, 16)))
    pc = pack_config(fast, G)
    packed = build_model(pack_params(state_dict, G), pc, "cpu")
    with torch.no_grad():
        ref = basic_unet_apply(model, x, fast).float()
        got = unpack_logits(basic_unet_apply(packed, pack_windows(x, G), pc), G).float()
    assert got.shape == ref.shape == (4, 32, 32, 16, 1)
    ulp = 2.0 ** (np.floor(np.log2(float(ref.abs().max()))) - 7)
    assert float((got - ref).abs().max()) <= 2 * ulp


def test_pack_unpack_roundtrip():
    x = torch.from_numpy(np.random.default_rng(1).random((8, 4, 4, 4, 1), np.float32))
    packed = pack_windows(x, 4)
    assert packed.shape == (2, 4, 4, 4, 4)
    assert torch.equal(unpack_logits(packed, 4), x)
    # window k·G + g is channel g of packed input k, as in the JAX package
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_pack_windows(jnp.asarray(x.numpy()), 4)))
    with pytest.raises(ValueError, match="not divisible"):
        pack_windows(x[:6], 4)
