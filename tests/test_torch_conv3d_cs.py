"""The port's conv3d_cs (plain version on the CPU) against the JAX package's
Pallas conv3d_cs in interpret mode, on the same numpy inputs; the plain
version of the pack step (conv3d_cs_pack_reference) against the prologue
built the way the plain conv built it before, bit for bit, its padded layout
(the channels in the slots the packed conv's K steps read, zeros elsewhere),
and a conv of its output, and the plain packed conv on the padded pack,
against the JAX kernel, also on planes wider than the packed ring (the
wide instance's shapes); the path rule and the shared-memory mirrors.

Tolerances: outputs within one bf16 ULP at their magnitude — both sides sum
the same bf16 products in f32, in other orders, and round once, so a sum
near a rounding boundary may land one step apart (tests/test_pallas_kernels.py
argues the same bound); the plain packed conv with a bias at one ULP of
max(|value|, rms), as the card tests hold the kernels. Stats within rtol
1e-3 of the f32 sums."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from delivr_cfos_tpu.ops.pallas.conv3d_cs import conv3d_cs as jax_conv3d_cs
from delivr_cfos_tpu_torch.ops.conv3d_cs import (
    DIRECT_BAND_BYTES,
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
    conv3d_cs_wide,
    direct_band_rows,
    kernel_weights,
    narrow_band_rows,
    narrow_k,
    narrow_smem_bytes,
    narrow_weights,
    packed_channels,
    packed_smem_bytes,
    packed_tile_rows,
    packed_wide,
    wide_smem_bytes,
    wide_tile_groups,
)
from delivr_cfos_tpu_torch.ops.conv3d_cs import NARROW_MAX, NARROW_SMEM_BYTES, SMEM_OPTIN
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, D, H, W = 2, 5, 6, 8


def _bf16_ulp(v):
    """One bf16 ULP at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), 2.0**-100)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_within_one_ulp(got, want, rms_floor=False):
    """``rms_floor``: the ULP at max(|value|, rms of want), as the card tests
    bound it — a sum of 27·C_in products plus a bias that cancels to near
    zero may differ by more than a ULP of the tiny result in f32 rounding,
    never by a ULP of the typical one."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(got), np.abs(want))
    if rms_floor:
        mag = np.maximum(mag, np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    bound = _bf16_ulp(mag)
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


def _prologue_then_pad(x, h, w, x2=None, bias2=None, in_affine=None):
    """The conv's input built as the plain version built it before the pack
    step: concat, pair bias and affine prologue on (B, D, C, H·W), then
    F.pad of the channels-last volume."""
    xf = x.float()
    if x2 is not None:
        x2f = x2.float()
        if bias2 is not None:
            x2f = (x2f + bias2.to(torch.bfloat16).float()[None, None, :, None])
            x2f = x2f.to(torch.bfloat16).float()
        xf = torch.cat([xf, x2f], dim=2)
    if in_affine is not None:
        a, c = in_affine
        v = xf * a[:, None, :, None] + c[:, None, :, None]
        xf = (v * torch.tanh(torch.nn.functional.softplus(v))).to(torch.bfloat16).float()
    b_, d, cin, _ = xf.shape
    x5 = xf.reshape(b_, d, cin, h, w).permute(0, 1, 3, 4, 2)
    return torch.nn.functional.pad(x5, (0, 0, 1, 1, 1, 1, 1, 1)).to(torch.bfloat16)


# kind: (C1, C2, C_out, what the input carries) of the pack and conv cases;
# the last five are C_in above 16 and not multiples of 16, which the pack
# pads to its slots
PACK_CASES = {
    "plain": (4, 0, 5, None), "pair": (4, 6, 5, "pair"), "affine": (4, 0, 5, "affine"),
    "c24": (24, 0, 24, None), "pair24_24": (24, 24, 24, "pair"),
    "affine20": (20, 0, 40, "affine"), "c17": (17, 0, 32, None),
    "pair16_8": (16, 8, 32, "pair"),
}


def _pack_case(kind, h, w):
    rng = np.random.default_rng(len(kind) * 100 + h * w)
    c1, c2, _, extra = PACK_CASES[kind]
    x = _bf16(rng.standard_normal((B, D, c1, h * w)) * 2)
    kw = {}
    if extra == "pair":
        kw["x2"] = _bf16(rng.standard_normal((B, D, c2, h * w)))
        kw["bias2"] = _t(rng.standard_normal(c2))
    if extra == "affine":
        kw["in_affine"] = (_t(rng.uniform(0.5, 1.5, (B, c1))),
                           _t(rng.normal(0, 0.3, (B, c1))))
    return x, kw


@pytest.mark.parametrize("h,w", [(H, W), (5, 7)])  # H·W = 48, and odd 35
@pytest.mark.parametrize("kind", ["plain", "pair", "affine"])
def test_pack_reference_is_the_plain_prologue_bit_for_bit(kind, h, w):
    x, kw = _pack_case(kind, h, w)
    got = conv3d_cs_pack_reference(x, h=h, w=w, **kw)
    want = _prologue_then_pad(x, h, w, **kw)
    assert got.dtype == torch.bfloat16
    assert got.shape == (B, D + 2, h + 2, w + 2, want.shape[-1])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the wrapper on a CPU tensor is the plain version of the kernel's
    # padded layout, and counts no launch
    before = conv3d_cs_pack.launches
    assert torch.equal(conv3d_cs_pack(x, h=h, w=w, **kw),
                       conv3d_cs_pack_reference(x, h=h, w=w, padded=True, **kw))
    assert conv3d_cs_pack.launches == before


@pytest.mark.parametrize("kind", list(PACK_CASES))
def test_padded_pack_puts_each_channel_in_its_slot_and_exact_zeros_elsewhere(kind):
    """The padded layout bit for bit: x in slots [0, C1), x2 (with its bias)
    in [C1p, C1p + C2), C1p = C1 padded to 8, Cp the sum of the padded
    counts padded to 16; every other slot, and the halo, an exact zero, with
    the affine prologue too (mish(c) ≠ 0 would be wrong there)."""
    x, kw = _pack_case(kind, H, W)
    c1, c2, _, _ = PACK_CASES[kind]
    c1p = -(-c1 // 8) * 8
    cp = packed_channels(c1, c2)
    assert cp % 16 == 0 and c1p + -(-c2 // 8) * 8 <= cp < c1p + -(-c2 // 8) * 8 + 16
    plain = conv3d_cs_pack_reference(x, h=H, w=W, **kw).view(torch.int16)
    got = conv3d_cs_pack_reference(x, h=H, w=W, padded=True, **kw).view(torch.int16)
    assert got.shape == (B, D + 2, H + 2, W + 2, cp)
    assert torch.equal(got[..., :c1], plain[..., :c1])
    assert torch.equal(got[..., c1p:c1p + c2], plain[..., c1:])
    pads = torch.ones(cp, dtype=torch.bool)
    pads[:c1] = pads[c1p:c1p + c2] = False
    assert not got[..., pads].any()
    if c1 % 16 == 0 and c2 % 16 == 0:
        assert torch.equal(got, plain)  # the production shapes: no slot moves


@pytest.mark.parametrize("h,w", [(H, W), (5, 7)])
@pytest.mark.parametrize("kind", list(PACK_CASES))
def test_conv_of_the_packed_input_matches_jax(kind, h, w):
    """F.conv3d without padding over the packed plain input, and the plain
    packed conv on the padded pack with the padded weights in the packed
    conv's block layout, against the JAX kernel in interpret mode on the
    same values: one bf16 ULP, stats rtol 1e-3."""
    x, kw = _pack_case(kind, h, w)
    rng = np.random.default_rng(11)
    c1, c2, cout, _ = PACK_CASES[kind]
    cin = c1 + c2
    wt = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    xp = conv3d_cs_pack_reference(x, h=h, w=w, **kw)
    w5 = _bf16(wt).float().permute(4, 3, 0, 1, 2)
    y = torch.nn.functional.conv3d(xp.float().permute(0, 4, 1, 2, 3), w5)
    got = y.permute(0, 2, 1, 3, 4).reshape(B, D, cout, h * w).to(torch.bfloat16)
    w_blk = block_weights(kernel_weights(_t(wt[:, :, :, :c1]),
                                         _t(wt[:, :, :, c1:]) if c2 else None, padded=True))
    xpp = conv3d_cs_pack_reference(x, h=h, w=w, padded=True, **kw)
    assert w_blk.shape == (-(-cout // 32), 27 * xpp.shape[-1], 32)
    got_p, st_p = conv3d_cs_packed_reference(xpp, w_blk, _t(bias), cout=cout, emit_stats=True)
    jx = jnp.asarray(_np(x), jnp.bfloat16)
    jkw = {}
    if c2:
        jkw["pair"] = (jnp.asarray(_np(kw["x2"]), jnp.bfloat16),
                       jnp.asarray(wt[:, :, :, c1:]), jnp.asarray(kw["bias2"].numpy()))
        wt = wt[:, :, :, :c1]
    if "in_affine" in kw:
        jkw["in_affine"] = tuple(jnp.asarray(t.numpy()) for t in kw["in_affine"])
    want = jax_conv3d_cs(jx, jnp.asarray(wt), None, h=h, w=w, interpret=True, **jkw)
    assert_within_one_ulp(_np(got), want)
    want_b, st_want = jax_conv3d_cs(jx, jnp.asarray(wt), jnp.asarray(bias), h=h, w=w,
                                    interpret=True, emit_stats=True, **jkw)
    assert_within_one_ulp(_np(got_p), want_b, rms_floor=True)
    assert_stats_close(st_p.numpy(), st_want)
    # the packed wrapper on a CPU tensor is that plain version
    again = conv3d_cs_packed(xpp, w_blk, _t(bias), cout=cout, emit_stats=True)
    assert torch.equal(again[0], got_p) and torch.equal(again[1], st_p)


def test_path_rule_and_block_weights():
    assert conv3d_cs_path(32, 0, 64, 32) == conv3d_cs_path(32, 32, 64, 32) == "packed"
    assert conv3d_cs_path(1, 0, 64, 4) == "narrow"
    # C_in above 16, not a multiple of 16: the packed conv on padded slots
    assert conv3d_cs_path(16, 8, 64, 32) == "packed"
    # 256-row tiles on the level-0/1/2 planes, 128 on levels 3-4
    assert [packed_tile_rows(96 >> i, 64 >> i) for i in range(5)] == [256, 256, 256, 128, 128]
    w = torch.arange(27 * 16 * 40, dtype=torch.float32).reshape(3, 3, 3, 16, 40)
    w_k = kernel_weights(w[..., :10, :], w[..., 10:, :])
    assert torch.equal(w_k, w.to(torch.bfloat16).reshape(27 * 16, 40))
    blk = block_weights(w_k)
    assert blk.shape == (2, 27 * 16, 32)
    assert torch.equal(blk[0], w_k[:, :32]) and torch.equal(blk[1, :, :8], w_k[:, 32:])
    assert not blk[1, :, 8:].any()


@pytest.mark.parametrize("c1,c2,w,cout,path", [
    (1, 0, 64, 32, "direct"),  # the first conv, 1 -> 32 on the 96 x 64 plane
    (1, 0, 7, 32, "narrow"),  # W not a multiple of 8
    (1, 0, 64, 4, "narrow"),  # C_out not a multiple of 8
    (3, 0, 64, 32, "narrow"),  # C_in neither 1 nor a multiple of 16
    (1, 0, 4096, 32, "packed"),  # wider than the direct and narrow convs' bands take
    (1, 8, 64, 32, "narrow"),  # pair mode never takes the direct conv
    (16, 16, 7, 4, "packed"),
    (2, 0, 64, 64, "narrow"),  # the packed first conv at G = 2
    (NARROW_MAX - 6, 6, 64, 32, "narrow"),  # C1 + C2 = NARROW_MAX
    (NARROW_MAX + 1, 0, 64, 32, "packed"),  # one more: padded to 32 slots
    (NARROW_MAX - 7, 8, 64, 32, "packed"),  # 9 + 8: slots 16 + 8, padded to 32
    (8, 0, 1024, 32, "packed"),  # not one row of the plane fits: the wide instance
    (24, 0, 64, 24, "packed"),  # a (24, 24, 48, 96, 192, 24) model's level 0
    (16, 8, 64, 32, "packed"),
    (24, 24, 32, 24, "packed"),  # its upcat_1.0: 48 slots, none a pad
    (15, 0, 300, 32, "packed"),  # the narrow conv stages no row; the ring fits
    (32, 0, 556, 32, "packed"),  # the widest plane the packed ring takes
    (32, 0, 557, 32, "packed"),  # one more: the wide instance
    (17, 0, 1024, 32, "packed"),
])
def test_conv3d_cs_path_rule(c1, c2, w, cout, path):
    assert conv3d_cs_path(c1, c2, w, cout) == path


def test_packed_ring_bytes_mirror_the_kernel():
    """``packed_smem_bytes`` is the kernel's 3 · packed_stage_elems · 2:
    90,720 bytes at 256-row tiles on the 64-wide plane (the source note);
    the widest plane a block's 232,448 bytes take is 556 columns."""
    assert packed_smem_bytes(256, 64) == 90_720
    assert packed_smem_bytes(256, 556) <= SMEM_OPTIN < packed_smem_bytes(256, 557)
    assert not packed_wide(556) and packed_wide(557)
    # a plane wider than 126 columns has 256-row tiles whatever its height
    assert packed_tile_rows(1, 127) == 256 and packed_tile_rows(1, 126) == 128


@pytest.mark.parametrize("w", [556, 557, 1024, 4096])
def test_wide_ring_bytes_mirror_the_kernel(w):
    """The wide instance's ring is the kernel's STAGES · wide_stage_elems ·
    2 = 3 · (6 · 66 · 24 + 9 · 16 · 40) · 2 = 91,584 bytes at every W (the
    source note: the 6 × 66 voxels around a 4 × 64 tile); the instance that
    takes a plane is the ring's up to 556 columns and the wide one above,
    whose block fits with room for 2 an SM."""
    assert wide_smem_bytes() == 3 * (6 * 66 * 24 + 9 * 16 * 40) * 2 == 91_584
    want = packed_smem_bytes(256, w) if w <= 556 else 91_584
    assert (wide_smem_bytes() if packed_wide(w) else packed_smem_bytes(256, w)) == want
    assert want <= SMEM_OPTIN
    assert packed_wide(w) == (w > 556)
    assert 2 * (wide_smem_bytes() + 1024) <= 228 * 1024


@pytest.mark.parametrize("h,w,planes,cout,cin,want", [
    (16, 1024, 32, 32, 32, (4, 16)),  # phase 4d's level 0: 2 windows of (16, 16, 1024)
    (16, 1024, 32, 32, 64, (4, 16)),  # its upcat_1.0
    (96, 640, 128, 32, 32, (60, 4)),  # 2 windows of (64, 96, 640)
    (96, 640, 128 * 64, 32, 32, None),  # many planes
    (1, 557, 1, 64, 32, (1, 9)),  # nine tiles, two C_out tiles: one block a tile
])
def test_wide_tile_groups_cover_the_plane_and_fill_the_card(h, w, planes, cout, cin, want):
    """Every 4 × 64 tile of the plane in exactly one group of at most
    ``per`` tiles; at least one wave of 2 blocks on each of 132 SMs wherever
    the tiles allow it; no other grouping of fewer waves × stages a block
    (3 · C/16 a tile, 2 to fill the ring), as the rule states."""
    tiles = -(-h // 4) * -(-w // 64)
    per, groups = wide_tile_groups(h, w, planes, cout, cin, 132)
    assert per * (groups - 1) < tiles <= per * groups
    n_ct, slots, stages = -(-cout // 32), 2 * 132, 3 * -(-cin // 16)
    assert n_ct * groups * planes >= min(slots, n_ct * tiles * planes)

    def cost(p):
        return -(-(n_ct * -(-tiles // p) * planes) // slots) * (p * stages + 2)

    fills = [p for p in range(1, tiles + 1)
             if n_ct * -(-tiles // p) * planes >= min(slots, n_ct * tiles * planes)]
    assert cost(per) == min(cost(p) for p in fills)
    if want is not None:
        assert (per, groups) == want


@pytest.mark.parametrize("c1,c2,cout", [(24, 0, 24), (17, 0, 32), (24, 24, 24),
                                         (16, 8, 40), (20, 0, 8), (32, 16, 8)])
def test_padded_kernel_weights_follow_the_pack_slots(c1, c2, cout):
    """Row tap·Cp + slot holds the weight of the concat channel in that slot,
    zero rows at the pad slots; the unpadded form where no slot moves."""
    g = torch.Generator().manual_seed(c1 * 100 + c2)
    w1 = torch.randn((3, 3, 3, c1, cout), generator=g)
    w2 = torch.randn((3, 3, 3, c2, cout), generator=g) if c2 else None
    cp, c1p = packed_channels(c1, c2), -(-c1 // 8) * 8
    wp = kernel_weights(w1, w2, padded=True)
    assert wp.dtype == torch.bfloat16 and wp.shape == (27 * cp, cout)
    taps = wp.view(27, cp, cout)
    unpadded = kernel_weights(w1, w2).view(27, c1 + c2, cout)
    assert torch.equal(taps[:, :c1], unpadded[:, :c1])
    assert torch.equal(taps[:, c1p:c1p + c2], unpadded[:, c1:])
    pads = torch.ones(cp, dtype=torch.bool)
    pads[:c1] = pads[c1p:c1p + c2] = False
    assert not taps[:, pads].any()
    if cp == c1 + c2:
        assert torch.equal(wp, kernel_weights(w1, w2))


@pytest.mark.parametrize("cin,h,w", [
    (2, 96, 64), (4, 96, 64), (3, 7, 9), (8, 48, 32), (NARROW_MAX, 96, 64),
    (1, 20, 1000),
])
def test_narrow_band_rows_fit_two_blocks_an_sm(cin, h, w):
    rows = narrow_band_rows(cin, h, w)
    assert 1 <= rows <= h
    assert narrow_smem_bytes(cin, rows, w) <= NARROW_SMEM_BYTES
    # equal bands: the fewest that fit, none of them short by more than a row
    bands = -(-h // rows)
    assert bands == 1 or narrow_smem_bytes(cin, -(-h // (bands - 1)), w) > NARROW_SMEM_BYTES
    assert rows * (bands - 1) < h
    # 2 blocks an SM: the H100's 228 KB an SM less 1 KB a block
    assert 2 * (NARROW_SMEM_BYTES + 1024) <= 228 * 1024
    # the packed first conv's whole 96 x 64 plane in one band
    if (cin, h, w) == (2, 96, 64):
        assert rows == 96
    with pytest.raises(ValueError):
        narrow_band_rows(cin, h, 100_000)


@pytest.mark.parametrize("c1,c2,cout", [(2, 0, 64), (3, 0, 6), (1, 0, 4), (4, 5, 40),
                                         (NARROW_MAX, 0, 8)])
def test_narrow_weights_layout(c1, c2, cout):
    """The narrow kernel's weights against kernel_weights: row n is output
    channel n, column k = tap·C_e + ci (C_e = C_in padded to even), zero
    for the pad channel of an odd C_in, past 27·C_e (K padded to 16) and
    past C_out (rows padded to 8)."""
    g = torch.Generator().manual_seed(c1 * 10 + c2)
    w1 = torch.randn((3, 3, 3, c1, cout), generator=g)
    w2 = torch.randn((3, 3, 3, c2, cout), generator=g) if c2 else None
    cin = c1 + c2
    ce = cin + cin % 2
    kp = narrow_k(cin)
    assert kp % 16 == 0 and 27 * ce <= kp < 27 * ce + 16
    assert narrow_k(2) == 64  # 54 padded to 64
    wn = narrow_weights(w1, w2)
    assert wn.dtype == torch.bfloat16 and wn.is_contiguous()
    assert wn.shape == (-(-cout // 8) * 8, kp)
    w_k = kernel_weights(w1, w2)  # (27·C_in, C_out)
    taps = wn[:cout, :27 * ce].reshape(cout, 27, ce)
    assert torch.equal(taps[:, :, :cin], w_k.reshape(27, cin, cout).permute(2, 0, 1))
    assert not taps[:, :, cin:].any()
    assert not wn[:, 27 * ce:].any() and not wn[cout:].any()


def test_packed_first_conv_shape_matches_jax():
    """The packed first conv (C_in = 2 → 64, with stats) on a small plane:
    the plain version against the JAX kernel in interpret mode, one bf16
    ULP, stats rtol 1e-3; the narrow and wide wrappers on a CPU tensor
    are that plain version and count no launch."""
    x, w, _ = _inputs(np.random.default_rng(17), 2, 64)
    want, st_want = jax_conv3d_cs(jnp.asarray(x), jnp.asarray(w), None,
                                  h=H, w=W, interpret=True, emit_stats=True)
    assert conv3d_cs_path(2, 0, W, 64) == "narrow"
    before = (conv3d_cs.launches, conv3d_cs_narrow.launches, conv3d_cs_packed.wide_launches)
    got, st = conv3d_cs(_bf16(x), _t(w), None, h=H, w=W, emit_stats=True)
    assert_within_one_ulp(_np(got), want)
    assert_stats_close(st.numpy(), st_want)
    for fn in (conv3d_cs_narrow, conv3d_cs_wide):
        again, st_again = fn(_bf16(x), _t(w), None, h=H, w=W, emit_stats=True)
        assert torch.equal(again, got) and torch.equal(st_again, st)
    assert (conv3d_cs.launches, conv3d_cs_narrow.launches,
            conv3d_cs_packed.wide_launches) == before


def test_direct_band_rows_fit_the_band_bytes():
    # the whole plane at the first conv's 96 x 64 and at small planes
    assert direct_band_rows(96, 64) == 96
    assert direct_band_rows(3, 16) == 3
    for h, w in ((96, 64), (4000, 512), (50, 2048)):
        rb = direct_band_rows(h, w)
        assert 1 <= rb <= h
        assert 3 * 4 * (rb + 2) * (w + 4) <= DIRECT_BAND_BYTES


@pytest.mark.parametrize("b,d,h,w,cout,extra", [
    (2, 5, 6, 8, 8, None),
    (1, 1, 3, 16, 32, None),  # D = 1: both neighbour planes are zero
    (2, 4, 12, 8, 32, "in_affine"),
    (3, 3, 7, 24, 40, "bias"),  # two channel tiles, the second ragged
])
def test_first_conv_plain_version_matches_jax_padded(b, d, h, w, cout, extra):
    """At the direct kernel's shapes (C_in = 1): the plain version against
    the JAX kernel in interpret mode, with input and weights padded to C_in
    = 2 as the JAX model pads them (the pad channel's prologue a = 1, c = 0
    gives mish(0) = 0, and its weights are zero). One bf16 ULP; stats rtol
    1e-3. The three wrappers on a CPU tensor are that plain version and
    count no launch."""
    rng = np.random.default_rng(b * 1000 + d * 100 + h * 10 + w + cout)
    x = rng.standard_normal((b, d, 1, h * w)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 3, 1, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32) if extra == "bias" else None
    aff = None
    if extra == "in_affine":
        aff = (rng.uniform(0.5, 1.5, (b, 1)).astype(np.float32),
               rng.normal(0, 0.3, (b, 1)).astype(np.float32))
    assert conv3d_cs_path(1, 0, w, cout) == "direct"
    jkw = {}
    if aff is not None:
        jkw["in_affine"] = (jnp.asarray(np.concatenate([aff[0], np.ones((b, 1), np.float32)], 1)),
                            jnp.asarray(np.concatenate([aff[1], np.zeros((b, 1), np.float32)], 1)))
    want, st_want = jax_conv3d_cs(
        jnp.asarray(np.concatenate([x, np.zeros_like(x)], axis=2)),
        jnp.asarray(np.concatenate([wt, np.zeros_like(wt)], axis=3)),
        None if bias is None else jnp.asarray(bias),
        h=h, w=w, interpret=True, emit_stats=True, **jkw)
    kw = dict(h=h, w=w, emit_stats=True,
              in_affine=None if aff is None else (_t(aff[0]), _t(aff[1])))
    tb = None if bias is None else _t(bias)
    before = (conv3d_cs.launches, conv3d_cs_direct.launches, conv3d_cs_packed.wide_launches)
    got, st = conv3d_cs(_bf16(x), _t(wt), tb, **kw)
    assert got.shape == (b, d, cout, h * w) and st.shape == (b, d, 2, cout)
    assert_within_one_ulp(_np(got), want)
    assert_stats_close(st.numpy(), st_want)
    for fn in (conv3d_cs_direct, conv3d_cs_wide):
        again, st_again = fn(_bf16(x), _t(wt), tb, **kw)
        assert torch.equal(again, got) and torch.equal(st_again, st)
    assert (conv3d_cs.launches, conv3d_cs_direct.launches,
            conv3d_cs_packed.wide_launches) == before


@pytest.mark.parametrize("c1,c2,cout,affine", [
    (32, 0, 32, False),  # a level-0 conv of the production model
    (32, 32, 32, False),  # its upcat_1.0: pair mode with the pair bias
    (24, 0, 24, True),  # padded slots (24 -> 32), with the prologue
    (24, 24, 24, False),  # 48 slots, pair mode
])
def test_conv3d_cs_on_a_wide_plane_matches_jax(c1, c2, cout, affine):
    """At W = 1024, wider than the packed ring, where the card takes the
    packed conv's wide instance: the port's ``conv3d_cs`` and its wide
    wrapper on CPU tensors (the plain version, no launch), and the plain
    packed conv on the padded pack, against the JAX kernel in interpret
    mode on the same values: one bf16 ULP (at max(|value|, rms) with the
    bias), stats rtol 1e-3."""
    b, d, h, w = 1, 2, 2, 1024
    assert conv3d_cs_path(c1, c2, w, cout) == "packed" and packed_wide(w)
    rng = np.random.default_rng(c1 * 100 + c2 + cout)
    cin = c1 + c2
    x = rng.standard_normal((b, d, c1, h * w)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    kw, jkw, pk = {}, {}, {}
    if c2:
        x2 = rng.standard_normal((b, d, c2, h * w)).astype(np.float32)
        b2 = (rng.standard_normal(c2) * 0.1).astype(np.float32)
        kw["pair"] = (_bf16(x2), _t(wt[:, :, :, c1:]), _t(b2))
        jkw["pair"] = (jnp.asarray(_np(_bf16(x2)), jnp.bfloat16),
                       jnp.asarray(wt[:, :, :, c1:]), jnp.asarray(b2))
        pk = dict(x2=_bf16(x2), bias2=_t(b2))
    if affine:
        a = rng.uniform(0.5, 1.5, (b, cin)).astype(np.float32)
        c = rng.normal(0, 0.3, (b, cin)).astype(np.float32)
        kw["in_affine"] = pk["in_affine"] = (_t(a), _t(c))
        jkw["in_affine"] = (jnp.asarray(a), jnp.asarray(c))
    w1 = wt[:, :, :, :c1]
    want, st_want = jax_conv3d_cs(jnp.asarray(_np(_bf16(x)), jnp.bfloat16), jnp.asarray(w1),
                                  jnp.asarray(bias), h=h, w=w, interpret=True,
                                  emit_stats=True, **jkw)
    before = (conv3d_cs.launches, conv3d_cs_packed.launches, conv3d_cs_packed.wide_launches)
    got, st = conv3d_cs(_bf16(x), _t(w1), _t(bias), h=h, w=w, emit_stats=True, **kw)
    assert_within_one_ulp(_np(got), want, rms_floor=True)
    assert_stats_close(st.numpy(), st_want)
    again, st_again = conv3d_cs_wide(_bf16(x), _t(w1), _t(bias), h=h, w=w, emit_stats=True,
                                     **kw)
    assert torch.equal(again, got) and torch.equal(st_again, st)
    xpp = conv3d_cs_pack(_bf16(x), h=h, w=w, **pk)
    assert xpp.shape == (b, d + 2, h + 2, w + 2, packed_channels(c1, c2))
    w_blk = block_weights(kernel_weights(_t(w1), kw["pair"][1] if c2 else None, padded=True))
    got_p, st_p = conv3d_cs_packed(xpp, w_blk, _t(bias), cout=cout, emit_stats=True)
    assert_within_one_ulp(_np(got_p), want, rms_floor=True)
    assert_stats_close(st_p.numpy(), st_want)
    assert (conv3d_cs.launches, conv3d_cs_packed.launches,
            conv3d_cs_packed.wide_launches) == before
