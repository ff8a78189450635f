"""The hand-written CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip where there is no card. They import neither JAX nor the JAX package, and
run on a GPU machine without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.ops.conv3d_cs import (
    block_weights,
    conv3d_cs,
    conv3d_cs_direct,
    conv3d_cs_narrow,
    conv3d_cs_pack,
    conv3d_cs_pack_reference,
    conv3d_cs_packed,
    conv3d_cs_packed_reference,
    conv3d_cs_path,
    conv3d_cs_reference,
    conv3d_cs_resources,
    conv3d_cs_wide,
    kernel_weights,
    narrow_band_rows,
    packed_channels,
    packed_wide,
)
from delivr_cfos_tpu_torch.ops.conv3d_cs import NARROW_MAX
from delivr_cfos_tpu_torch.ops.deconv2x_cs import (
    MAX_C,
    deconv2x_cs,
    deconv2x_cs_plan,
    deconv2x_cs_reference,
    deconv2x_cs_resources,
)
from delivr_cfos_tpu_torch.ops.instance_norm_mish import (
    instance_norm_mish,
    instance_norm_mish_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _ulps(got, want):
    """Largest |got − want| in bf16 ULPs at each value's magnitude, floored at
    the output's rms: near zero the two f32 sums of 27·C_in products may
    differ by more than a ULP of the tiny result, never of the typical one."""
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), max(rms, 2.0**-100))
    return float((np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)).max())


@pytest.mark.parametrize("b,d,h,w,cin,c2,cout,affine", [
    # narrow path (C1 + C2 <= NARROW_MAX, not multiples of 16): odd C_in,
    # the affine prologue, pair mode
    (2, 5, 6, 8, 1, 0, 4, False),
    (2, 5, 6, 8, 3, 0, 6, True),
    (1, 4, 9, 7, 4, 5, 40, False),
    # packed path: level-0/1/2-like rows, the 6 x 4 plane of level 4, an odd
    # width, pair mode, the prologue, a plane of one tile row
    (2, 4, 5, 64, 16, 0, 32, False),
    (2, 6, 6, 4, 64, 0, 32, False),
    (1, 3, 5, 7, 16, 16, 24, False),
    (1, 3, 9, 16, 32, 0, 40, True),
    (2, 3, 7, 32, 16, 16, 32, False),
    (1, 2, 3, 128, 48, 16, 8, False),
    # packed path on padded slots (C_in above 16, not a multiple of 16)
    (1, 3, 9, 16, 20, 0, 40, True),
    (2, 3, 6, 24, 24, 24, 24, False),
])
def test_conv3d_cs_kernel_matches_plain_version(dev, b, d, h, w, cin, c2, cout,
                                                affine):
    g = torch.Generator().manual_seed(cin * 100 + cout + w)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    x = rnd(b, d, cin, h * w).to(torch.bfloat16)
    wt = rnd(3, 3, 3, cin, cout, scale=0.2)
    bias = rnd(cout)
    kw = {}
    if c2:
        kw["pair"] = (rnd(b, d, c2, h * w).to(torch.bfloat16),
                      rnd(3, 3, 3, c2, cout, scale=0.2), rnd(c2))
    if affine:
        kw["in_affine"] = (rnd(b, cin).abs() + 0.5, rnd(b, cin, scale=0.3))
    # C_in = 1 with C_out = 4 takes the narrow kernel, not the direct one
    unpadded = cin % 16 == 0 and c2 % 16 == 0
    assert conv3d_cs_path(cin, c2, w, cout) == (
        "packed" if unpadded or cin + c2 > NARROW_MAX else "narrow")
    before = conv3d_cs.launches
    got, st = conv3d_cs(x, wt, bias, h=h, w=w, emit_stats=True, **kw)
    torch.cuda.synchronize()
    assert conv3d_cs.launches == before + 1
    want, st_want = conv3d_cs_reference(x, wt, bias, h=h, w=w,
                                        emit_stats=True, **kw)
    assert _ulps(got, want) <= 1.0
    torch.testing.assert_close(
        st, st_want, rtol=1e-3, atol=1e-3 * float(st_want.abs().max())
    )


@pytest.mark.parametrize("b,d,h,w,c1,c2,cout", [
    # packed path, shapes that leave the ring's last tile ragged: one
    # partial tile (36 virtual rows of 128), a last tile of one row
    # (1 x 257), the 256-row tiles with a last tile of 82 rows
    # (9 x 66 = 594), three channel chunks a tap plane (C_in = 48), C_out
    # cut into a full and a partial 32-wide block
    (2, 3, 6, 4, 16, 0, 32),
    (1, 2, 1, 255, 32, 0, 16),
    (1, 3, 9, 64, 32, 16, 40),
    (2, 2, 5, 9, 48, 0, 72),
    # padded slots: 24 → 32 on the level-0 row, 24 + 24 (48 slots, no pad),
    # 17 → 32 on a ragged plane, 16 + 8 → 32, 20 → 32 with C_out 40
    (2, 3, 6, 64, 24, 0, 24),
    (1, 3, 9, 16, 24, 24, 24),
    (2, 2, 5, 9, 17, 0, 32),
    (1, 2, 7, 32, 16, 8, 32),
    (1, 3, 8, 40, 20, 0, 40),
])
def test_conv3d_cs_packed_ring_with_ragged_tiles(dev, b, d, h, w, c1, c2, cout):
    g = torch.Generator().manual_seed(h * 1000 + w)
    x = torch.randn((b, d, c1, h * w), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((3, 3, 3, c1, cout), generator=g) * 0.2).to(dev)
    kw = {}
    if c2:
        kw["pair"] = (torch.randn((b, d, c2, h * w), generator=g).to(dev, torch.bfloat16),
                      (torch.randn((3, 3, 3, c2, cout), generator=g) * 0.2).to(dev),
                      torch.randn((c2,), generator=g).to(dev))
    assert conv3d_cs_path(c1, c2, w, cout) == "packed"
    before = conv3d_cs.launches, conv3d_cs_pack.launches
    got, st = conv3d_cs(x, wt, None, h=h, w=w, emit_stats=True, **kw)
    torch.cuda.synchronize()
    assert (conv3d_cs.launches, conv3d_cs_pack.launches) == (before[0] + 1, before[1] + 1)
    want, st_want = conv3d_cs_reference(x, wt, None, h=h, w=w, emit_stats=True, **kw)
    assert _ulps(got, want) <= 1.0
    torch.testing.assert_close(
        st, st_want, rtol=1e-3, atol=1e-3 * float(st_want.abs().max())
    )
    # the stats reduce in a fixed order: the same bits on every launch
    again = conv3d_cs(x, wt, None, h=h, w=w, emit_stats=True, **kw)
    assert torch.equal(again[0], got) and torch.equal(again[1], st)


@pytest.mark.parametrize("b,d,h,w,c1,c2,bias2,affine", [
    # 16-byte loads (H·W % 8 == 0): the level-0 row, W = 4 (8 voxels cross
    # two rows), pair mode with its bias, the affine prologue
    (2, 3, 4, 64, 32, 0, False, False),
    (2, 6, 6, 4, 64, 0, False, True),
    (1, 3, 9, 16, 32, 32, True, False),
    # one voxel a load: ragged planes (H·W = 35, 15), C = 8 groups
    (1, 3, 5, 7, 16, 16, True, False),
    (2, 2, 3, 5, 8, 0, False, True),
    # padded slots: C1 = 24, 20 (with the prologue: its pads stay zero) and
    # 17, 24 + 24 with the pair bias, 16 + 8, and 17 one voxel a load
    (2, 3, 4, 64, 24, 0, False, False),
    (1, 3, 6, 16, 20, 0, False, True),
    (2, 2, 4, 64, 17, 0, False, False),
    (1, 3, 9, 16, 24, 24, True, False),
    (1, 2, 6, 16, 16, 8, True, False),
    (1, 3, 5, 7, 17, 0, False, True),
])
def test_conv3d_cs_pack_kernel_matches_plain_version(dev, b, d, h, w, c1, c2,
                                                     bias2, affine):
    """Bit for bit: the kernel rounds as the plain version does (the pair
    bias sum once, the affine product and sum apart, PyTorch's mish), and
    writes the plain version's padded slots, exact zeros at the pads."""
    g = torch.Generator().manual_seed(c1 * 10 + c2 + w)
    x = (torch.randn((b, d, c1, h * w), generator=g) * 2).to(dev, torch.bfloat16)
    kw = {}
    if c2:
        kw["x2"] = torch.randn((b, d, c2, h * w), generator=g).to(dev, torch.bfloat16)
    if bias2:
        kw["bias2"] = torch.randn((c2,), generator=g).to(dev)
    if affine:
        kw["in_affine"] = ((torch.rand((b, c1 + c2), generator=g) + 0.5).to(dev),
                           (torch.randn((b, c1 + c2), generator=g) * 0.3).to(dev))
    before = conv3d_cs_pack.launches, conv3d_cs_pack.padded_launches
    got = conv3d_cs_pack(x, h=h, w=w, **kw)
    torch.cuda.synchronize()
    padded = packed_channels(c1, c2) != c1 + c2
    assert (conv3d_cs_pack.launches, conv3d_cs_pack.padded_launches) == (
        before[0] + 1, before[1] + padded)
    want = conv3d_cs_pack_reference(x, h=h, w=w, padded=True, **kw)
    assert got.shape == want.shape == (b, d + 2, h + 2, w + 2, packed_channels(c1, c2))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_conv3d_cs_pack_on_a_misaligned_view(dev):
    """A contiguous input that starts off a 16-byte boundary is read one
    voxel at a time and gives the plain version's bits."""
    base = torch.randn(1 + 2 * 3 * 16 * 32, device=dev).to(torch.bfloat16)
    x = base[1:].reshape(2, 3, 16, 32)
    got = conv3d_cs_pack(x, h=4, w=8)
    assert torch.equal(got, conv3d_cs_pack_reference(x, h=4, w=8))
    # 12 channels of a misaligned view: 16 slots, the last four zeros
    base12 = torch.randn(1 + 2 * 3 * 12 * 32, device=dev).to(torch.bfloat16)
    x12 = base12[1:].reshape(2, 3, 12, 32)
    got12 = conv3d_cs_pack(x12, h=4, w=8)
    assert got12.shape[-1] == 16 and not got12[..., 12:].view(torch.int16).any()
    assert torch.equal(got12, conv3d_cs_pack_reference(x12, h=4, w=8, padded=True))


def test_conv3d_cs_direct_on_a_misaligned_view(dev):
    """A contiguous C_in = 1 input that starts off a 16-byte boundary is
    staged one voxel a load and gives the plain version's values."""
    base = torch.randn(1 + 2 * 3 * 6 * 16, device=dev).to(torch.bfloat16)
    x = base[1:].reshape(2, 3, 1, 6 * 16)
    wt = torch.randn((3, 3, 3, 1, 16), device=dev) * 0.2
    assert conv3d_cs_path(1, 0, 16, 16) == "direct"
    before = conv3d_cs_direct.launches
    got, st = conv3d_cs(x, wt, None, h=6, w=16, emit_stats=True)
    assert conv3d_cs_direct.launches == before + 1
    want, st_want = conv3d_cs_reference(x, wt, None, h=6, w=16, emit_stats=True)
    assert _ulps(got, want) <= 1.0
    torch.testing.assert_close(
        st, st_want, rtol=1e-3, atol=1e-3 * float(st_want.abs().max())
    )


def test_conv3d_cs_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 2, 3, 16, dtype=torch.float32, device=dev)
    wt = torch.zeros(3, 3, 3, 3, 4, device=dev)
    with pytest.raises(TypeError):
        conv3d_cs(x, wt, None, h=4, w=4)
    with pytest.raises(ValueError):
        conv3d_cs(x.to(torch.bfloat16), wt, None, h=4, w=5)
    # the packed conv reads past xp's end into storage conv3d_cs_pack adds
    xb = torch.zeros(1, 2, 16, 16, dtype=torch.bfloat16, device=dev)
    xp = conv3d_cs_pack(xb, h=4, w=4)
    w_blk = block_weights(kernel_weights(torch.zeros(3, 3, 3, 16, 8, device=dev)))
    conv3d_cs_packed(xp, w_blk, None, cout=8)
    with pytest.raises(ValueError, match="past its end"):
        conv3d_cs_packed(xp.clone(), w_blk, None, cout=8)
    # the direct conv takes C_in = 1 with W and C_out multiples of 8 only
    x1 = torch.zeros(1, 2, 1, 16, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="direct conv"):
        conv3d_cs_direct(x1, torch.zeros(3, 3, 3, 1, 4, device=dev), None, h=4, w=4)


@pytest.mark.parametrize("c1,c2,affine", [(24, 0, False), (20, 0, True), (17, 0, False),
                                          (24, 24, False)])
def test_conv3d_cs_padded_packed_conv_matches_plain_versions(dev, c1, c2, affine):
    """The packed conv on padded slots: within one bf16 ULP of
    conv3d_cs_reference (unpadded) and of conv3d_cs_packed_reference on the
    same xp and padded weights, stats rtol 1e-3, the same bits on a second
    launch."""
    g = torch.Generator().manual_seed(c1 * 10 + c2)
    b, d, h, w, cout = 2, 4, 12, 64, 24
    x = torch.randn((b, d, c1, h * w), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((3, 3, 3, c1, cout), generator=g) * 0.2).to(dev)
    bias = torch.randn((cout,), generator=g).to(dev)
    kw, pk = {}, {}
    if c2:
        x2 = torch.randn((b, d, c2, h * w), generator=g).to(dev, torch.bfloat16)
        w2 = (torch.randn((3, 3, 3, c2, cout), generator=g) * 0.2).to(dev)
        b2 = torch.randn((c2,), generator=g).to(dev)
        kw["pair"], pk = (x2, w2, b2), dict(x2=x2, bias2=b2)
    if affine:
        kw["in_affine"] = pk["in_affine"] = (
            (torch.rand((b, c1), generator=g) + 0.5).to(dev),
            (torch.randn((b, c1), generator=g) * 0.3).to(dev))
    assert conv3d_cs_path(c1, c2, w, cout) == "packed"
    xp = conv3d_cs_pack(x, h=h, w=w, **pk)
    w_blk = block_weights(kernel_weights(wt, kw["pair"][1] if c2 else None, padded=True))
    before = conv3d_cs_packed.launches
    got, st = conv3d_cs_packed(xp, w_blk, bias, cout=cout, emit_stats=True)
    torch.cuda.synchronize()
    assert conv3d_cs_packed.launches == before + 1
    tol = lambda s: dict(rtol=1e-3, atol=1e-3 * float(s.abs().max()))  # noqa: E731
    for want, st_want in (
            conv3d_cs_reference(x, wt, bias, h=h, w=w, emit_stats=True, **kw),
            conv3d_cs_packed_reference(xp, w_blk, bias, cout=cout, emit_stats=True)):
        assert _ulps(got, want) <= 1.0
        torch.testing.assert_close(st, st_want, **tol(st_want))
    again = conv3d_cs(x, wt, bias, h=h, w=w, emit_stats=True, **kw)
    assert torch.equal(again[0], got) and torch.equal(again[1], st)


def test_conv3d_cs_planes_wider_than_the_packed_ring_take_the_wide_instance(dev):
    """At C 32 → 32 the packed ring fits planes up to 556 wide; a 1024-wide
    plane takes the packed conv's wide instance and matches its plain
    version."""
    g = torch.Generator().manual_seed(1024)
    for w, wide in ((556, False), (1024, True)):
        x = torch.randn((1, 3, 32, 4 * w), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((3, 3, 3, 32, 32), generator=g) * 0.1).to(dev)
        assert conv3d_cs_path(32, 0, w, 32) == "packed" and packed_wide(w) == wide
        before = conv3d_cs_packed.wide_launches, conv3d_cs_packed.launches
        got, st = conv3d_cs(x, wt, None, h=4, w=w, emit_stats=True)
        torch.cuda.synchronize()
        assert (conv3d_cs_packed.wide_launches - before[0],
                conv3d_cs_packed.launches - before[1]) == (int(wide), 1)
        want, st_want = conv3d_cs_reference(x, wt, None, h=4, w=w, emit_stats=True)
        assert _ulps(got, want) <= 1.0
        torch.testing.assert_close(st, st_want, rtol=1e-3,
                                   atol=1e-3 * float(st_want.abs().max()))


@pytest.mark.parametrize("b,d,h,w,c1,c2,cout,affine,bias", [
    # the widths: just past the ring, phase 4d's level 0, a plane of
    # one row too wide for every other kernel
    (1, 3, 4, 557, 32, 0, 32, False, True),
    (2, 2, 16, 1024, 32, 0, 32, False, False),
    (1, 2, 1, 4096, 16, 0, 40, False, True),
    # pair mode with the pair bias, the affine prologue
    (1, 3, 5, 1024, 32, 32, 32, False, True),
    (1, 2, 6, 640, 64, 0, 64, True, True),
    # padded slots: C_in 8 (no band row of the narrow conv fits), 17, 24
    # and 24 + 24; H·W not a multiple of 8 (one voxel a load)
    (1, 3, 3, 1024, 8, 0, 32, False, True),
    (2, 2, 3, 601, 17, 0, 24, True, False),
    (1, 3, 5, 1023, 24, 0, 24, False, True),
    (1, 2, 7, 777, 24, 24, 24, False, True),
])
def test_conv3d_cs_wide_instance_matches_plain_version(dev, b, d, h, w, c1, c2, cout,
                                                       affine, bias):
    """The packed conv's wide instance, taken by the rule on planes wider
    than the ring: within one bf16 ULP at max(|value|, rms) of
    conv3d_cs_reference and of conv3d_cs_packed_reference on the same xp,
    stats rtol 1e-3 with atol 1e-3·max|Σ|, the same bits on a second
    launch (its stats pass adds the blocks' partials in a fixed order)."""
    g = torch.Generator().manual_seed(w * 10 + c1 + c2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    cin = c1 + c2
    x = rnd(b, d, c1, h * w).to(torch.bfloat16)
    wt = rnd(3, 3, 3, c1, cout, scale=0.2)
    bt = rnd(cout) if bias else None
    kw, pk = dict(h=h, w=w, emit_stats=True), {}
    if c2:
        kw["pair"] = (rnd(b, d, c2, h * w).to(torch.bfloat16),
                      rnd(3, 3, 3, c2, cout, scale=0.2), rnd(c2))
        pk = dict(x2=kw["pair"][0], bias2=kw["pair"][2])
    if affine:
        kw["in_affine"] = pk["in_affine"] = (rnd(b, cin).abs() + 0.5, rnd(b, cin, scale=0.3))
    assert conv3d_cs_path(c1, c2, w, cout) == "packed" and packed_wide(w)
    before = conv3d_cs.launches, conv3d_cs_packed.wide_launches, conv3d_cs_pack.launches
    got, st = conv3d_cs(x, wt, bt, **kw)
    torch.cuda.synchronize()
    assert (conv3d_cs.launches, conv3d_cs_packed.wide_launches, conv3d_cs_pack.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    xp = conv3d_cs_pack(x, h=h, w=w, **pk)
    w_blk = block_weights(kernel_weights(wt, kw["pair"][1] if c2 else None, padded=True))
    tol = lambda s: dict(rtol=1e-3, atol=1e-3 * float(s.abs().max()))  # noqa: E731
    for want, st_want in (
            conv3d_cs_reference(x, wt, bt, **kw),
            conv3d_cs_packed_reference(xp, w_blk, bt, cout=cout, emit_stats=True)):
        assert _ulps(got, want) <= 1.0
        torch.testing.assert_close(st, st_want, **tol(st_want))
    again = conv3d_cs(x, wt, bt, **kw)
    assert torch.equal(again[0], got) and torch.equal(again[1], st)
    # without stats: the same output, no second pass
    alone = conv3d_cs_packed(xp, w_blk, bt, cout=cout)
    assert torch.equal(alone, got)
    regs, blocks = conv3d_cs_resources("packed", h, w, cin)
    assert 0 < regs <= 128 and blocks >= 2


def test_no_production_shape_launches_the_wide_instance(dev):
    """The full-width fast forward on one (96, 96, 64) window: 18 conv3d_cs
    launches, 17 on the packed conv's ring, none on its wide instance."""
    from delivr_cfos_tpu_torch.models.basic_unet import (
        BasicUNetConfig, build_model, init_state_dict,
    )
    from delivr_cfos_tpu_torch.models.basic_unet_cs import apply_cs

    cfg = BasicUNetConfig()
    model = build_model(init_state_dict(cfg, torch.Generator().manual_seed(0)), cfg, dev)
    x = torch.rand((1, 96, 96, 64, 1), generator=torch.Generator().manual_seed(1)).to(dev)
    before = conv3d_cs.launches, conv3d_cs_packed.launches, conv3d_cs_packed.wide_launches
    with torch.no_grad():
        apply_cs(model, x * 1000)
    torch.cuda.synchronize()
    assert (conv3d_cs.launches - before[0], conv3d_cs_packed.launches - before[1],
            conv3d_cs_packed.wide_launches - before[2]) == (18, 17, 0)


@pytest.mark.parametrize("b,d,h,w,cout,extra", [
    (2, 5, 6, 8, 8, None),
    (1, 1, 3, 16, 32, None),  # D = 1: both neighbour planes are zero
    (2, 4, 12, 8, 32, "in_affine"),
    (3, 3, 7, 24, 40, "bias"),  # two channel tiles, the second ragged
])
def test_conv3d_cs_direct_kernel_matches_plain_version(dev, b, d, h, w, cout, extra):
    """The C_in = 1 first conv's kernel: within one bf16 ULP at max(|value|,
    rms) (f32 FMAs of exact bf16 products, summed in another order), stats
    rtol 1e-3, the same bits on a second launch; the wide instance of the
    packed conv on the same inputs within the same bound."""
    g = torch.Generator().manual_seed(b * 1000 + d * 100 + h * 10 + w + cout)
    x = torch.randn((b, d, 1, h * w), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((3, 3, 3, 1, cout), generator=g) * 0.2).to(dev)
    bias = torch.randn((cout,), generator=g).to(dev) if extra == "bias" else None
    aff = None
    if extra == "in_affine":
        aff = ((torch.rand((b, 1), generator=g) + 0.5).to(dev),
               (torch.randn((b, 1), generator=g) * 0.3).to(dev))
    assert conv3d_cs_path(1, 0, w, cout) == "direct"
    before = conv3d_cs.launches, conv3d_cs_direct.launches, conv3d_cs_packed.wide_launches
    got, st = conv3d_cs(x, wt, bias, h=h, w=w, emit_stats=True, in_affine=aff)
    torch.cuda.synchronize()
    assert (conv3d_cs.launches, conv3d_cs_direct.launches,
            conv3d_cs_packed.wide_launches) == (before[0] + 1, before[1] + 1, before[2])
    want, st_want = conv3d_cs_reference(x, wt, bias, h=h, w=w, emit_stats=True, in_affine=aff)
    assert _ulps(got, want) <= 1.0
    torch.testing.assert_close(
        st, st_want, rtol=1e-3, atol=1e-3 * float(st_want.abs().max())
    )
    again = conv3d_cs(x, wt, bias, h=h, w=w, emit_stats=True, in_affine=aff)
    assert torch.equal(again[0], got) and torch.equal(again[1], st)
    on_wide, st_g = conv3d_cs_wide(x, wt, bias, h=h, w=w, emit_stats=True, in_affine=aff)
    torch.cuda.synchronize()
    assert conv3d_cs_packed.wide_launches == before[2] + 1
    assert _ulps(on_wide, want) <= 1.0
    torch.testing.assert_close(
        st_g, st_want, rtol=1e-3, atol=1e-3 * float(st_want.abs().max())
    )


@pytest.mark.parametrize("b,d,h,w,c1,c2,cout,affine", [
    (2, 5, 6, 8, 1, 0, 4, False),  # C_in 1, C_out 4: one n8 block
    (2, 4, 96, 64, 2, 0, 64, False),  # the packed first conv's plane, one band
    (1, 3, 9, 7, 3, 0, 6, True),  # odd C_in and W: the pad channel, scalar loads, stores
    (1, 4, 9, 7, 4, 5, 40, False),  # pair 4 + 5
    (1, 3, 40, 64, 8, 8, 24, False),  # pair 8 + 8: bands of 7 rows, passes of 32
    (2, 2, 30, 64, NARROW_MAX - 6, 6, 72, False),  # C1 + C2 = NARROW_MAX: bands, 3 passes
    (2, 2, 11, 24, NARROW_MAX - 1, 0, 40, True),  # odd, with the prologue, 2 passes
    (1, 3, 96, 64, 4, 0, 128, False),  # G = 4's first conv: 3 bands x 2 passes
])
def test_conv3d_cs_narrow_kernel_matches_plain_version(dev, b, d, h, w, c1, c2, cout,
                                                       affine):
    """The narrow kernel: within one bf16 ULP at max(|value|, rms) (exact bf16
    products summed in f32 in another order), stats rtol 1e-3 with atol
    1e-3·max|Σ|, the same bits on a second launch; the wide instance of the
    packed conv on the same inputs within the same bound."""
    g = torch.Generator().manual_seed(b * 1000 + h * 10 + w + c1 * 7 + c2 + cout)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    cin = c1 + c2
    x = rnd(b, d, c1, h * w).to(torch.bfloat16)
    wt = rnd(3, 3, 3, c1, cout, scale=0.2)
    kw = dict(h=h, w=w, emit_stats=True)
    if c2:
        kw["pair"] = (rnd(b, d, c2, h * w).to(torch.bfloat16),
                      rnd(3, 3, 3, c2, cout, scale=0.2), rnd(c2))
    if affine:
        kw["in_affine"] = (rnd(b, cin).abs() + 0.5, rnd(b, cin, scale=0.3))
    bias = rnd(cout)
    assert conv3d_cs_path(c1, c2, w, cout) == "narrow"
    assert 1 <= narrow_band_rows(cin, h, w) <= h
    before = conv3d_cs.launches, conv3d_cs_narrow.launches, conv3d_cs_packed.wide_launches
    got, st = conv3d_cs(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert (conv3d_cs.launches, conv3d_cs_narrow.launches,
            conv3d_cs_packed.wide_launches) == (before[0] + 1, before[1] + 1, before[2])
    want, st_want = conv3d_cs_reference(x, wt, bias, **kw)
    assert _ulps(got, want) <= 1.0
    tol = dict(rtol=1e-3, atol=1e-3 * float(st_want.abs().max()))
    torch.testing.assert_close(st, st_want, **tol)
    again = conv3d_cs_narrow(x, wt, bias, **kw)
    assert torch.equal(again[0], got) and torch.equal(again[1], st)
    on_wide, st_g = conv3d_cs_wide(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert conv3d_cs_packed.wide_launches == before[2] + 1
    assert _ulps(on_wide, want) <= 1.0
    torch.testing.assert_close(st_g, st_want, **tol)
    regs, blocks = conv3d_cs_resources("narrow", h, w, cin)
    assert 0 < regs <= 128 and blocks >= 2


def test_conv3d_cs_narrow_block_diagonal_equals_per_window(dev):
    """The packed first conv (models/packing.py, G = 2: C 2 → 64 with
    block-diagonal weights) against each window alone with a zero second
    channel (C 2 → 32): outputs and stats equal to the bit, whatever C_out
    does to the split of a pass's channels between warps."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4, 2, 24 * 64), generator=g).to(dev, torch.bfloat16)
    w1 = (torch.randn((3, 3, 3, 1, 32), generator=g) * 0.2).to(dev)
    wp = torch.zeros((3, 3, 3, 2, 64), device=dev)
    wp[..., :1, :32] = w1
    wp[..., 1:, 32:] = w1
    got, st = conv3d_cs(x, wp, None, h=24, w=64, emit_stats=True)
    for k in range(2):
        xk = torch.zeros_like(x)
        xk[:, :, 0] = x[:, :, k]
        w_one = torch.cat([w1, torch.zeros_like(w1)], dim=3)
        want, st_want = conv3d_cs(xk, w_one, None, h=24, w=64, emit_stats=True)
        assert torch.equal(got[:, :, 32 * k:32 * k + 32], want)
        assert torch.equal(st[..., 32 * k:32 * k + 32], st_want)


def test_conv3d_cs_narrow_on_a_misaligned_view_and_without_stats(dev):
    """A contiguous input that starts off a 16-byte boundary is staged one
    voxel a load; without stats the output is the same; the wrapper raises
    on a shape outside the narrow contract."""
    base = torch.randn(1 + 2 * 3 * 2 * 6 * 16, device=dev).to(torch.bfloat16)
    x = base[1:].reshape(2, 3, 2, 6 * 16)
    wt = torch.randn((3, 3, 3, 2, 16), device=dev) * 0.2
    got, st = conv3d_cs_narrow(x, wt, None, h=6, w=16, emit_stats=True)
    want, st_want = conv3d_cs_reference(x, wt, None, h=6, w=16, emit_stats=True)
    assert _ulps(got, want) <= 1.0
    torch.testing.assert_close(
        st, st_want, rtol=1e-3, atol=1e-3 * float(st_want.abs().max())
    )
    assert torch.equal(conv3d_cs_narrow(x, wt, None, h=6, w=16), got)
    wide = torch.zeros(1, 2, NARROW_MAX + 1, 16, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="narrow conv"):
        conv3d_cs_narrow(wide, torch.zeros(3, 3, 3, NARROW_MAX + 1, 8, device=dev), None,
                         h=4, w=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 4, 8, 16, 32),  # aligned planes
    (1, 3, 5, 7, 8),  # odd S = 105: scalar head and tail around the vectors
    (2, 8, 1, 1, 1),  # one-voxel planes: variance 0
    (1, 2, 96, 96, 64),  # a full-resolution plane, many vectors per thread
])
def test_instance_norm_mish_kernel_matches_plain_version(dev, dtype, shape):
    """f32 within rtol 1e-4, atol 1e-5 (tests/test_pallas_kernels.py's
    bound); bf16 within one ULP at max(|value|, rms), as for conv3d_cs."""
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 3 + 0.5).to(dev, dtype)
    scale = (torch.rand(shape[1], generator=g) + 0.5).to(dev)
    bias = (torch.randn(shape[1], generator=g) * 0.2).to(dev)
    before = instance_norm_mish.launches
    got = instance_norm_mish(x, scale, bias)
    torch.cuda.synchronize()
    assert instance_norm_mish.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = instance_norm_mish_reference(x, scale, bias)
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert _ulps(got, want) <= 1.0
    # the statistics reduce in a fixed order: the same bits on every launch
    assert torch.equal(instance_norm_mish(x, scale, bias), got)


def test_instance_norm_mish_kernel_on_a_misaligned_view(dev):
    """A contiguous view that starts off a 16-byte boundary takes the scalar
    path and gives the same values."""
    base = torch.randn(1 + 2 * 3 * 40, device=dev)
    x = base[1:].reshape(2, 3, 2, 4, 5)
    scale, bias = torch.ones(3, device=dev), torch.zeros(3, device=dev)
    torch.testing.assert_close(instance_norm_mish(x, scale, bias),
                               instance_norm_mish_reference(x, scale, bias),
                               rtol=1e-4, atol=1e-5)


def test_instance_norm_mish_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 2, 3, 4, 5, device=dev)
    with pytest.raises(ValueError):
        instance_norm_mish(x.transpose(2, 3), torch.ones(2, device=dev),
                           torch.zeros(2, device=dev))
    with pytest.raises(ValueError):
        instance_norm_mish(x, torch.ones(3, device=dev), torch.zeros(3, device=dev))
    with pytest.raises(TypeError):
        instance_norm_mish(x.half(), torch.ones(2, device=dev), torch.zeros(2, device=dev))


@pytest.mark.parametrize("b,d,c,h,w,o,with_bias", [
    # the four UpCats of the production forward (window 96 x 96 x 64) at a
    # batch of 2: upcat_4 .. upcat_1, the last with a bias
    (2, 6, 256, 6, 4, 128, False),
    (2, 12, 128, 12, 8, 64, False),
    (2, 24, 64, 24, 16, 32, False),
    (2, 48, 32, 48, 32, 32, True),
    (2, 6, 256, 6, 4, 128, True),
    # small planes: H·W = 24 with W = 4, several planes a block, a 1 x 4
    # plane (inputs staged one voxel at a time), odd W (4-byte stores), odd C
    # and O, a ragged last voxel tile, the largest C the kernel takes
    (3, 2, 16, 6, 4, 8, True),
    (2, 11, 16, 6, 4, 24, True),  # 8 planes a block, a ragged last run of 3
    (1, 1, 16, 1, 4, 16, False),
    (2, 3, 5, 3, 5, 3, True),
    (1, 2, 48, 9, 10, 20, False),
    (1, 2, MAX_C, 2, 4, 17, False),
])
def test_deconv2x_cs_kernel_matches_plain_version(dev, b, d, c, h, w, o, with_bias):
    """Within one bf16 ULP at max(|value|, rms): both sum the same exact bf16
    products in f32, in their own orders, and round once."""
    g = torch.Generator().manual_seed(c * 100 + o + w)
    x = torch.randn((b, d, c, h * w), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((c, o, 2, 2, 2), generator=g) / (8 * c) ** 0.5).to(dev)
    bias = torch.randn((o,), generator=g).to(dev) if with_bias else None
    before = deconv2x_cs.launches
    got = deconv2x_cs(x, wt, bias, h=h, w=w)
    torch.cuda.synchronize()
    assert deconv2x_cs.launches == before + 1
    assert got.shape == (b, 2 * d, o, 4 * h * w) and got.dtype == torch.bfloat16
    want = deconv2x_cs_reference(x, wt, bias, h=h, w=w)
    assert _ulps(got, want) <= 1.0
    # a fixed K order: the same bits on every launch
    assert torch.equal(deconv2x_cs(x, wt, bias, h=h, w=w), got)


@pytest.mark.parametrize("b,d,c,h,w,o,with_bias", [
    # 64-voxel tiles across planes and batches, B·D·H·W = 360 not a multiple
    # of the tile
    (3, 5, 16, 6, 4, 8, False),
    # C not a multiple of the 32-channel K chunk: a ragged last chunk
    (2, 3, 48, 6, 4, 16, True),
    (1, 4, 80, 12, 8, 24, False),
    (1, 2, MAX_C, 4, 8, 40, True),
    # 8·O not a multiple of the 256-column N tile
    (2, 3, 32, 6, 4, 20, False),
    (2, 2, 64, 6, 4, 40, True),
    # upcat_4 and upcat_1 at a batch of 3
    (3, 6, 256, 6, 4, 128, False),
    # upcat_4 of the full-width model packed two windows a call
    # (models/packing.py): 512 channels in, 256 out
    (2, 6, 512, 6, 4, 256, False),
    (3, 48, 32, 48, 32, 32, True),
])
def test_deconv2x_cs_kernel_tiles(dev, b, d, c, h, w, o, with_bias):
    """The flattened GEMM's ragged edges: within one bf16 ULP at
    max(|value|, rms) of the plain version, the same bits on a relaunch."""
    g = torch.Generator().manual_seed(b * 1000 + c * 10 + o)
    x = torch.randn((b, d, c, h * w), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((c, o, 2, 2, 2), generator=g) / (8 * c) ** 0.5).to(dev)
    bias = torch.randn((o,), generator=g).to(dev) if with_bias else None
    before = deconv2x_cs.launches
    got = deconv2x_cs(x, wt, bias, h=h, w=w)
    torch.cuda.synchronize()
    assert deconv2x_cs.launches == before + 1
    assert _ulps(got, deconv2x_cs_reference(x, wt, bias, h=h, w=w)) <= 1.0
    assert torch.equal(deconv2x_cs(x, wt, bias, h=h, w=w), got)


def test_deconv2x_cs_refuses_a_call_of_2_30_voxels(dev):
    """The kernel's voxel indices are 32-bit: a call of 2^30 input voxels
    is refused before anything is allocated or launched."""
    x = torch.empty((1, 1, 1, 1 << 30), dtype=torch.bfloat16, device=dev)
    wt = torch.zeros((1, 1, 2, 2, 2), device=dev)
    before = deconv2x_cs.launches
    with pytest.raises(ValueError, match="2\\^30"):
        deconv2x_cs(x, wt, None, h=1 << 15, w=1 << 15)
    assert deconv2x_cs.launches == before


def test_deconv2x_cs_resources(dev):
    """The production instance (16-byte staging, output runs) keeps two
    blocks an SM, which the plan's grid assumes."""
    regs, blocks = deconv2x_cs_resources(True, True)
    assert 0 < regs <= 128 and blocks >= 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert deconv2x_cs_plan(128 * 48, 48, 32, 32, x_aligned=True,
                            sms=sms).m_blocks == 2 * sms


def test_deconv2x_cs_kernel_on_a_misaligned_view(dev):
    """A contiguous input that starts off a 16-byte boundary is staged one
    voxel at a time and gives the plain version's values."""
    base = torch.randn(1 + 2 * 3 * 16 * 32, device=dev).to(torch.bfloat16)
    x = base[1:].reshape(2, 3, 16, 32)
    wt = torch.randn((16, 8, 2, 2, 2), device=dev) / 8
    got = deconv2x_cs(x, wt, None, h=4, w=8)
    assert _ulps(got, deconv2x_cs_reference(x, wt, None, h=4, w=8)) <= 1.0


def test_deconv2x_cs_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 2, 16, 24, dtype=torch.bfloat16, device=dev)
    wt = torch.zeros(16, 8, 2, 2, 2, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        deconv2x_cs(x.transpose(1, 2).contiguous().transpose(1, 2), wt, h=6, w=4)
    with pytest.raises(TypeError):
        deconv2x_cs(x.float(), wt, h=6, w=4)
    with pytest.raises(ValueError):
        deconv2x_cs(x, wt, h=5, w=4)  # h·w is not the plane size
    with pytest.raises(ValueError):
        deconv2x_cs(x, wt[:8], h=6, w=4)  # weights for another C
    with pytest.raises(ValueError):
        deconv2x_cs(x, wt, torch.zeros(8, dtype=torch.bfloat16, device=dev), h=6, w=4)
    big = torch.zeros(1, 1, MAX_C + 16, 4, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="input channels"):
        deconv2x_cs(big, torch.zeros(MAX_C + 16, 4, 2, 2, 2, device=dev), h=2, w=2)
