"""The port's deconv2x_cs (its plain version, which CPU tensors take) against
the JAX package's ``_deconv2x_cs`` under both ``DELIVR_DECONV_IMPL`` forms
and against the TPU kernel it replaces, ``scripts/probe_deconv.py``'s
``_variant_d``, run in interpret mode, on the same numpy inputs.

The bound is 1 bf16 ULP at max(|value|, rms of the output): every side sums
the same exact bf16 products in f32, in its own order, and rounds once. On
this CPU it held bit for bit at every shape and form below (the assertion
keeps the stated bound)."""

import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from delivr_cfos_tpu.models.basic_unet_cs import _deconv2x_cs as jax_deconv2x_cs
from delivr_cfos_tpu_torch.models import basic_unet_cs
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.ops.deconv2x_cs import (
    deconv2x_cs,
    deconv2x_cs_reference,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, D, C, H, W, O): a level-4 plane of H·W = 24 with W = 4, an aligned
# level, odd C, H, W and O
SHAPES = [(2, 3, 16, 6, 4, 8), (1, 2, 32, 4, 8, 16), (2, 2, 5, 3, 5, 3)]


def _inputs(shape, seed):
    b, d, c, h, w, o = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d, c, h * w)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wt = (rng.standard_normal((c, o, 2, 2, 2)) / np.sqrt(8 * c)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    return x, wt, bias


def _port(x, wt, bias, h, w):
    return deconv2x_cs(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wt),
        None if bias is None else torch.from_numpy(bias), h=h, w=w,
    ).float().numpy()


def _ulps(got, want):
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), max(rms, 2.0**-100))
    return float((np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)).max())


@pytest.mark.parametrize("impl", ["convt", "dot"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_deconv2x_cs(monkeypatch, impl, shape):
    monkeypatch.setenv("DELIVR_DECONV_IMPL", impl)
    b, d, c, h, w, o = shape
    x, wt, _ = _inputs(shape, seed=sum(shape))
    want = np.asarray(
        jax_deconv2x_cs(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), None, h, w),
        np.float32,
    )
    got = _port(x, wt, None, h, w)
    assert got.shape == want.shape == (b, 2 * d, o, 4 * h * w)
    assert _ulps(got, want) <= 1.0


def _probe(shape):
    """scripts/probe_deconv.py as a fresh module with its shape globals set
    to ``shape``; the script itself is not changed."""
    spec = importlib.util.spec_from_file_location(
        "probe_deconv_under_test", os.path.join(ROOT, "scripts", "probe_deconv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    b, d, c, h, w, o = shape
    mod.B, mod.D, mod.C, mod.H, mod.W, mod.O, mod.S = b, d, c, h, w, o, h * w
    return mod


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("y_mode", ["stack", "split"])
@pytest.mark.parametrize("shape", [(2, 4, 8, 8, 6, 4), (2, 3, 16, 6, 4, 8)])
def test_plain_version_matches_the_tpu_kernel(shape, y_mode, with_bias):
    """The Pallas kernel always adds its f32 bias; "without" is a zero bias
    there and None here."""
    b, d, c, h, w, o = shape
    x, wt, bias = _inputs(shape, seed=7 + sum(shape))
    tpu_bias = bias if with_bias else np.zeros(o, np.float32)
    want = np.asarray(
        _probe(shape)._variant_d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt),
                                 jnp.asarray(tpu_bias), y_mode),
        np.float32,
    )
    got = _port(x, wt, bias if with_bias else None, h, w)
    assert got.shape == want.shape == (b, 2 * d, o, 4 * h * w)
    assert _ulps(got, want) <= 1.0


def test_layout_and_rounding_of_one_voxel():
    """out[b, 2d+a, o, (2y+β)·2W + 2x+γ] = bf16(Σ_c x·w[c, o, a, β, γ] + bias),
    written out voxel by voxel in f64 from the bf16 operands."""
    shape = (1, 2, 3, 2, 3, 2)
    b, d, c, h, w, o = shape
    x, wt, bias = _inputs(shape, seed=11)
    wb = torch.from_numpy(wt).to(torch.bfloat16).double().numpy()
    got = _port(x, wt, bias, h, w)
    for dd, a, oo, yy, be, xx, ga in np.ndindex(d, 2, o, h, 2, w, 2):
        v = float(np.dot(x[0, dd, :, yy * w + xx].astype(np.float64),
                         wb[:, oo, a, be, ga])) + float(bias[oo])
        want = float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float())
        assert got[0, 2 * dd + a, oo, (2 * yy + be) * 2 * w + 2 * xx + ga] == want


def test_cpu_tensors_take_the_plain_version():
    x, wt, bias = _inputs(SHAPES[0], seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = deconv2x_cs.launches
    got = deconv2x_cs(xt, torch.from_numpy(wt), torch.from_numpy(bias), h=6, w=4)
    assert deconv2x_cs.launches == before
    assert torch.equal(got, deconv2x_cs_reference(
        xt, torch.from_numpy(wt), torch.from_numpy(bias), h=6, w=4))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        deconv2x_cs(xt.to("meta"), torch.from_numpy(wt).to("meta"), h=6, w=4)


def test_fast_forward_runs_every_upcat_through_deconv2x_cs(monkeypatch):
    """apply_cs calls the wrapper once per UpCat and never the library's
    transposed convolution."""
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return deconv2x_cs(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("apply_cs called F.conv_transpose3d")

    monkeypatch.setattr(basic_unet_cs, "deconv2x_cs", spy)
    monkeypatch.setattr(torch.nn.functional, "conv_transpose3d", refuse)
    feats = (4, 4, 8, 16, 32, 4)
    sd = init_state_dict(BasicUNetConfig(features=feats), torch.Generator().manual_seed(0))
    model = build_model(sd, BasicUNetConfig(features=feats), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).random((1, 16, 32, 16, 1), np.float32))
    out = basic_unet_cs.apply_cs(model, x)
    assert out.shape == (1, 16, 32, 16, 1) and torch.isfinite(out.float()).all()
    # (B, D, C, H·W) at levels 4, 3, 2, 1
    assert calls == [(1, 1, 32, 2), (1, 2, 16, 8), (1, 4, 8, 32), (1, 8, 4, 128)]


def test_kernel_weight_layout():
    """The B operand: w_k[c, 8·o + 4a + 2β + γ] = bf16(w[c, o, a, β, γ]),
    no padding past O, K-major, contiguous and 16-byte aligned."""
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import kernel_weights

    wt = torch.randn(3, 20, 2, 2, 2)
    wk = kernel_weights(wt)
    assert wk.shape == (3, 8 * 20) and wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert wk.data_ptr() % 16 == 0
    for c, o, a, be, ga in np.ndindex(3, 20, 2, 2, 2):
        want = wt[c, o, a, be, ga].to(torch.bfloat16)
        assert float(wk[c, 8 * o + 4 * a + 2 * be + ga]) == float(want)


def test_kernel_weights_take_an_aligned_bf16_tensor_as_it_is():
    """A contiguous bf16 weight is the B operand itself, with no copy; a
    view that starts off a 16-byte boundary is copied to an aligned one."""
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import kernel_weights

    wt = torch.randn(4, 3, 2, 2, 2).to(torch.bfloat16)
    assert kernel_weights(wt).data_ptr() == wt.data_ptr()
    base = torch.randn(1 + 4 * 3 * 8).to(torch.bfloat16)
    view = base[1:].reshape(4, 3, 2, 2, 2)
    wk = kernel_weights(view)
    assert wk.data_ptr() % 16 == 0 and torch.equal(wk, view.reshape(4, 24))


# (planes B·D, H, W, O) → (N tiles, M tiles, m_blocks, vec_in, fast_out) on
# 132 SMs with x aligned: the four UpCats of the production forward at the
# stage-2 batch of 128 windows, then the odd shapes of the card tests
PLANS = [
    ((128 * 6, 6, 4, 128), (4, 288, 66, True, True)),  # upcat_4
    ((128 * 12, 12, 8, 64), (2, 2304, 132, True, True)),  # upcat_3
    ((128 * 24, 24, 16, 32), (1, 18432, 264, True, True)),  # upcat_2
    ((128 * 48, 48, 32, 32), (1, 147456, 264, True, True)),  # upcat_1
    ((3 * 5, 6, 4, 8), (1, 6, 6, True, True)),  # tiles across planes and batches
    ((2 * 3, 3, 5, 3), (1, 2, 2, False, False)),  # odd C, H, W, O
    ((1 * 2, 9, 10, 20), (1, 3, 3, False, False)),  # W = 10 does not divide a tile
    ((1 * 2, 2, 4, 17), (1, 1, 1, True, True)),  # one ragged tile
    ((1 * 1, 1, 4, 16), (1, 1, 1, False, True)),  # a 4-voxel plane
    ((2 * 2, 6, 4, 40), (2, 2, 2, True, True)),  # 8·O = 320: a ragged N tile
]


@pytest.mark.parametrize("args,want", PLANS)
def test_deconv2x_cs_plan(args, want):
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import deconv2x_cs_plan

    assert tuple(deconv2x_cs_plan(*args, x_aligned=True, sms=132)) == want


def test_deconv2x_cs_plan_of_a_misaligned_input_and_a_huge_call():
    """A misaligned x stages one voxel at a time; a call of 2^30 input
    voxels or more is refused, one voxel fewer is one launch."""
    from delivr_cfos_tpu_torch.ops.deconv2x_cs import MAX_VOXELS, deconv2x_cs_plan

    assert not deconv2x_cs_plan(6, 4, 8, 8, x_aligned=False, sms=132).vec_in
    assert deconv2x_cs_plan(6, 4, 8, 8, x_aligned=False, sms=132).fast_out
    assert MAX_VOXELS == 1 << 30 > 100 * 128 * 48 * 1536  # the largest UpCat call
    with pytest.raises(ValueError, match="2\\^30"):
        deconv2x_cs_plan(4, 1 << 14, 1 << 14, 8, x_aligned=True, sms=132)
    plan = deconv2x_cs_plan(1, 1, (1 << 30) - 1, 8, x_aligned=True, sms=132)
    assert plan.m_tiles == 1 << 24 and plan.m_blocks == 264
