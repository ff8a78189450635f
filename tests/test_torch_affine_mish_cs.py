"""The fast forward's epilogue op, ``ops/affine_mish_cs.py``.

On the CPU (tier 1): the wrapper runs the plain version, bit for bit the
formula the fast forward used before the kernel; ``apply_cs`` sends every one
of its 18 epilogues through the op and calls ``F.softplus`` nowhere else; the
wrapper refuses what the kernel does not take.

On the card (marker ``cuda``; skips without one): the CUDA kernel within one
bf16 ULP of the plain version at every element.

The LeakyReLU and residual instances (``affine_act_cs``, SwinUNETR's residual
blocks): on the CPU the plain version is the formula written out; on the
card each instance within one bf16 ULP of it, and the mish instance that
BasicUNet runs gives the same bits through either entry. This file imports neither
JAX nor the JAX package, so it runs on a GPU machine without
tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_affine_mish_cs.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.models import basic_unet_cs
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.ops.affine_mish_cs import (
    affine_act_cs,
    affine_act_cs_reference,
    affine_mish_cs,
    affine_mish_cs_reference,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FEATURES = (32, 32, 64, 128, 256, 32)
WINDOW = (96, 96, 64)


def _epilogue_shapes(features, window, batch):
    """(B, D, C, H·W) of the 18 epilogues of one fast forward, in call order:
    two a block, at the levels of conv_0, down_1..4, upcat_4..1."""
    f = features
    blocks = [(0, f[0])] + [(i, f[i]) for i in range(1, 5)]
    blocks += [(3, f[3]), (2, f[2]), (1, f[1]), (0, f[5])]
    d, h, w = window
    return [(batch, d >> lvl, c, (h >> lvl) * (w >> lvl))
            for lvl, c in blocks for _ in range(2)]


def _inputs(shape, seed, spread=4.0):
    b, _, c, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * spread).to(torch.bfloat16)
    a = torch.rand((b, c), generator=g) + 0.25
    cc = torch.randn((b, c), generator=g)
    return x, a, cc


def _former_formula(x, a, c):
    """The fast forward's epilogue before the kernel, as it stood in
    models/basic_unet_cs.py."""
    v = x.float().mul_(a[:, None, :, None]).add_(c[:, None, :, None])
    return v.mul_(F.softplus(v).tanh_()).to(torch.bfloat16)


# --- on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 4, 37), (1, 2, 8, 24), (3, 1, 2, 1)])
def test_cpu_tensors_take_the_plain_version_bit_for_bit(shape):
    x, a, c = _inputs(shape, seed=sum(shape))
    x[0, 0, 0, 0] = 30.0  # past softplus's threshold
    x[-1, -1, -1, -1] = -100.0
    keep = x.clone()
    before = affine_mish_cs.launches
    got = affine_mish_cs(x, a, c)
    assert affine_mish_cs.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got.view(torch.int16), _former_formula(x, a, c).view(torch.int16))
    assert torch.equal(affine_mish_cs_reference(x, a, c), got)
    assert torch.equal(x, keep)


def test_fast_forward_runs_every_epilogue_through_affine_mish_cs(monkeypatch):
    """apply_cs calls the op once per epilogue, 18 times, at the shapes of
    its convs' outputs, and never F.softplus outside it."""
    calls, inside = [], [False]
    real_softplus = F.softplus

    def softplus(*args, **kw):
        if not inside[0]:
            raise AssertionError("apply_cs called F.softplus outside affine_mish_cs")
        return real_softplus(*args, **kw)

    def spy(x, a, c):
        calls.append(tuple(x.shape))
        inside[0] = True
        try:
            return affine_mish_cs(x, a, c)
        finally:
            inside[0] = False

    monkeypatch.setattr(basic_unet_cs, "affine_mish_cs", spy)
    monkeypatch.setattr(torch.nn.functional, "softplus", softplus)
    feats = (4, 4, 8, 16, 32, 4)
    cfg = BasicUNetConfig(features=feats)
    model = build_model(init_state_dict(cfg, torch.Generator().manual_seed(0)), cfg, "cpu")
    window = (16, 32, 16)
    x = torch.from_numpy(np.random.default_rng(0).random((1, *window, 1), np.float32))
    out = basic_unet_cs.apply_cs(model, x)
    assert out.shape == (1, *window, 1) and torch.isfinite(out.float()).all()
    assert calls == _epilogue_shapes(feats, window, 1)


@pytest.mark.parametrize("case", ["x_f32", "x_f16", "a_shape", "c_shape", "a_f64",
                                  "c_transposed", "x_transposed", "x_3d", "x_meta"])
def test_affine_mish_cs_rejects_what_the_kernel_does_not_take(case):
    x, a, c = _inputs((2, 3, 4, 5), seed=1)
    error = ValueError
    if case == "x_f32":
        x, error = x.float(), TypeError
    elif case == "x_f16":
        x, error = x.half(), TypeError
    elif case == "a_shape":
        a = a[:, :3]
    elif case == "c_shape":
        c = c.reshape(-1)
    elif case == "a_f64":
        a = a.double()
    elif case == "c_transposed":
        c = torch.randn(4, 2).t()
    elif case == "x_transposed":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "x_3d":
        x = x[0]
    elif case == "x_meta":
        x, a, c = x.to("meta"), a.to("meta"), c.to("meta")
    with pytest.raises(error):
        affine_mish_cs(x, a, c)


def _former_act(x, a, c, act, residual):
    """SwinUNETR's epilogue written out: lrelu or mish of (x·a + c) +
    (r·a_r + c_r) in f32, one bf16 rounding."""
    v = x.float() * a[:, None, :, None] + c[:, None, :, None]
    if residual is not None:
        r, ar, cr = residual
        v = v + (r.float() * ar[:, None, :, None] + cr[:, None, :, None])
    if act == "lrelu":
        return torch.where(v > 0, v, v * 0.01).to(torch.bfloat16)
    return (v * torch.tanh(F.softplus(v))).to(torch.bfloat16)


def _residual(shape, seed):
    r, ar, cr = _inputs(shape, seed)
    return r, ar, cr


@pytest.mark.parametrize("act", ["lrelu", "mish"])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 4, 37), (1, 2, 48, 24)])
def test_act_instances_on_the_cpu_are_the_formula(act, with_residual, shape):
    x, a, c = _inputs(shape, seed=sum(shape))
    res = _residual(shape, seed=sum(shape) + 1) if with_residual else None
    before = affine_act_cs.launches
    got = affine_act_cs(x, a, c, act=act, residual=res)
    assert affine_act_cs.launches == before
    assert torch.equal(got.view(torch.int16), _former_act(x, a, c, act, res).view(torch.int16))
    if act == "mish" and res is None:
        assert torch.equal(got, affine_mish_cs(x, a, c))


@pytest.mark.parametrize("case", ["act", "r_shape", "r_f32", "ar_shape"])
def test_affine_act_cs_rejects_what_the_kernel_does_not_take(case):
    x, a, c = _inputs((2, 3, 4, 5), seed=1)
    r, ar, cr = _residual((2, 3, 4, 5), seed=2)
    act, error = "lrelu", ValueError
    if case == "act":
        act = "relu"
    elif case == "r_shape":
        r = r[:, :2].contiguous()
    elif case == "r_f32":
        r, error = r.float(), TypeError
    elif case == "ar_shape":
        ar = ar[:, :2].contiguous()
    with pytest.raises(error):
        affine_act_cs(x, a, c, act=act, residual=(r, ar, cr))


# --- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _ulps(got, want):
    """Largest |got − want| in bf16 ULPs at each plain value's own magnitude
    (bf16's subnormal spacing, 2^-133, below 2^-126)."""
    g = got.double().cpu()
    w = want.double().cpu()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    g, w = g[~torch.isnan(w)], w[~torch.isnan(w)]
    mag = w.abs().clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def _check(dev, x, a, c):
    """Run the kernel on (x, a, c) moved to the card: one launch, x left as
    it was, a new bf16 tensor within one ULP of the plain version."""
    x, a, c = x.to(dev), a.to(dev), c.to(dev)
    keep = x.clone()
    before = affine_mish_cs.launches
    got = affine_mish_cs(x, a, c)
    torch.cuda.synchronize()
    assert affine_mish_cs.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert got.data_ptr() != x.data_ptr()
    assert torch.equal(x, keep)
    ulps = _ulps(got, affine_mish_cs_reference(x, a, c))
    assert ulps <= 1.0, ulps
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _epilogue_shapes(FEATURES, WINDOW, 2)
                         + [(2, 3, 5, 37), (2, 4, 7, 36), (3, 2, 3, 5), (2, 3, 4, 1),
                            (1, 1, 1, 7), (1, 1, 1, 8), (1, 1, 1, 9)])
def test_affine_mish_cs_kernel_matches_plain_version(dev, shape):
    """The 18 epilogue shapes of the full-width forward at batch 2, then
    planes that are not multiples of 8 (vectors that straddle rows, several
    rows a vector) and tensors shorter than a vector or two."""
    _check(dev, *_inputs(shape, seed=sum(shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("lag", range(1, 8))
@pytest.mark.parametrize("s", [37, 24])
def test_affine_mish_cs_kernel_on_a_misaligned_view(dev, lag, s):
    """A contiguous view whose data pointer is ``lag`` elements past a
    16-byte boundary: the scalar head, vectors from the first boundary, and
    the output aligned as x is."""
    shape = (2, 3, 5, s)
    x, a, c = _inputs(shape, seed=lag)
    base = torch.zeros(lag + x.numel(), dtype=torch.bfloat16, device=dev)
    assert base.data_ptr() % 16 == 0
    view = base[lag:].view(shape)
    view.copy_(x.to(dev))
    got = _check(dev, view, a, c)
    assert got.data_ptr() % 16 == view.data_ptr() % 16


@pytest.mark.cuda
@pytest.mark.parametrize("centre", [-90.0, -20.0, 0.0, 20.0, 90.0])
def test_affine_mish_cs_kernel_at_the_edges_of_mish(dev, centre):
    """x·a + c spread around −90 (subnormal results), −20, 0, 20 (softplus's
    threshold) and 90 (past it), with the factors of a real epilogue."""
    b, d, ch, s = 2, 3, 4, 41
    g = torch.Generator().manual_seed(int(centre) + 100)
    a = torch.rand((b, ch), generator=g) + 0.25
    c = torch.randn((b, ch), generator=g) * 3
    v = centre + torch.linspace(-3.0, 3.0, d * s).reshape(1, d, 1, s).expand(b, d, ch, s)
    x = ((v - c[:, None, :, None]) / a[:, None, :, None]).to(torch.bfloat16).contiguous()
    _check(dev, x, a, c)


@pytest.mark.cuda
def test_affine_mish_cs_kernel_rejects_what_it_does_not_take(dev):
    x, a, c = (t.to(dev) for t in _inputs((2, 3, 4, 5), seed=2))
    with pytest.raises(ValueError):
        affine_mish_cs(x.transpose(1, 2), a, c)
    with pytest.raises(ValueError):
        affine_mish_cs(x, a.cpu(), c)
    with pytest.raises(TypeError):
        affine_mish_cs(x.float(), a, c)


@pytest.mark.cuda
def test_fast_forward_launches_the_kernel_at_every_epilogue(dev):
    """One full-width fast forward on the card: 18 launches, and logits
    finite."""
    cfg = BasicUNetConfig()
    model = build_model(init_state_dict(cfg, torch.Generator().manual_seed(0)), cfg, dev)
    x = torch.rand((2, *WINDOW, 1), generator=torch.Generator().manual_seed(1)).to(dev)
    before = affine_mish_cs.launches
    with torch.no_grad():
        out = basic_unet_cs.apply_cs(model, x * 1000)
    torch.cuda.synchronize()
    assert affine_mish_cs.launches - before == 18
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["lrelu", "mish"])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 96, 48, 96 * 64), (2, 3, 5, 37), (3, 2, 3, 5),
                                   (1, 1, 1, 9), (2, 2, 768, 6)])
def test_act_instances_match_plain_version(dev, act, with_residual, shape):
    """SwinUNETR's epilogue shapes (48 channels at full resolution, 768 on
    the bottom stage's 3 × 2 plane) and planes that are not multiples of 8,
    within one bf16 ULP; LeakyReLU without a residual to the bit."""
    x, a, c = (t.to(dev) for t in _inputs(shape, seed=sum(shape)))
    res = None
    if with_residual:
        res = tuple(t.to(dev) for t in _residual(shape, seed=sum(shape) + 1))
    before = affine_act_cs.launches
    got = affine_act_cs(x, a, c, act=act, residual=res)
    torch.cuda.synchronize()
    assert affine_act_cs.launches == before + 1
    want = affine_act_cs_reference(x, a, c, act, res)
    assert _ulps(got, want) <= 1.0
    if act == "lrelu":
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("lag", [0, 3])
def test_act_instance_with_a_misaligned_residual(dev, lag):
    """A residual whose alignment differs from x's is copied to x's."""
    shape = (2, 3, 5, 37)
    x, a, c = (t.to(dev) for t in _inputs(shape, seed=5))
    r, ar, cr = (t.to(dev) for t in _residual(shape, seed=6))
    base = torch.zeros(lag + r.numel() + 8, dtype=torch.bfloat16, device=dev)
    view = base[lag + 1:lag + 1 + r.numel()].view(shape)
    view.copy_(r)
    got = affine_act_cs(x, a, c, act="lrelu", residual=(view, ar, cr))
    want = affine_act_cs_reference(x, a, c, "lrelu", (r, ar, cr))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _epilogue_shapes(FEATURES, WINDOW, 2)[:4] + [(2, 3, 5, 37)])
def test_mish_instance_is_unchanged(dev, shape):
    """BasicUNet's mish instance: the same bits through ``affine_mish_cs``
    and ``affine_act_cs(act="mish")``, within one ULP of the plain version."""
    x, a, c = (t.to(dev) for t in _inputs(shape, seed=sum(shape)))
    old = affine_mish_cs(x, a, c)
    new = affine_act_cs(x, a, c, act="mish")
    torch.cuda.synchronize()
    assert torch.equal(old.view(torch.int16), new.view(torch.int16))
    assert _ulps(old, affine_mish_cs_reference(x, a, c)) <= 1.0
