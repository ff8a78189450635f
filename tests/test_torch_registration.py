"""The port's registration library (delivr_cfos_tpu_torch/registration)
against the JAX package's on the CPU, on the same numpy inputs.

Tolerances, as measured on these inputs:
- ``sample_volume``, ``inside_weight``, ``moments_init``, ``_axis_basis``
  and the chunked ``_points_field``: equal to the bit (eager JAX rounds each
  operation as torch does);
- ``affine_apply``: within 1e-5 absolute at coordinates below 100 (the two
  matmuls may fuse their multiply-adds differently);
- the similarities and their gradients w.r.t. the affine and the control
  points: within rtol 1e-4 of ``jax.grad`` (sums in another order), with
  the integer-coordinate case where ``jnp.clip`` splits the gradient at a
  tie;
- the dense optimizers: the port's affine maps the test points within 0.1
  voxel of JAX's and its score is within 1e-3 (measured: 2e-5 voxel and
  5e-6 on the recovery case); Adam rounds in another order, so no run is
  asked to agree to the bit;
- the sampled optimizers draw their lattice jitter from torch generators,
  not from ``jax.random``: they are held to the JAX tests' recovery bounds,
  not to JAX's numbers.

The mirrors of tests/test_registration.py, tests/test_registration_crosscheck.py
and the synthetic cases of tests/test_registration_acceptance.py keep their
bounds; the acceptance solves are slow there and here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delivr_cfos_tpu.registration import affine as jaffine
from delivr_cfos_tpu.registration import bspline as jbspline
from delivr_cfos_tpu.registration import warp as jwarp
from delivr_cfos_tpu.registration import (
    register_affine as jax_register_affine,
    register_bspline as jax_register_bspline,
    warp_points as jax_warp_points,
)
from delivr_cfos_tpu_torch.registration import affine as taffine
from delivr_cfos_tpu_torch.registration import bspline as tbspline
from delivr_cfos_tpu_torch.registration import warp as twarp
from delivr_cfos_tpu_torch.registration import (
    BSplineField,
    register_affine,
    register_bspline,
    warp_points,
)
from delivr_cfos_tpu_torch.registration.affine import (
    masked_mi,
    register_affine_multistart,
    sample_coords,
    step_generator,
)
from delivr_cfos_tpu_torch.registration.landmarks import (
    affine_from_landmarks,
    read_marker_file,
)
from delivr_cfos_tpu_torch.registration.validate import (
    acceptance_metrics,
    affine_ffd_transform_fn,
    affine_transform_fn,
    apply_transform_volume,
    lsfm_degrade,
    make_synthetic_atlas,
    sample_brain_points,
)
from test_registration import _brain_like
from test_registration_acceptance import _true_affine as _acceptance_affine
from test_registration_crosscheck import _scipy_register
from test_registration_crosscheck import _true_affine as _crosscheck_affine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
TEST_AFFINE = np.array(
    [[1.08, 0.03, 0.0, -2.0], [-0.02, 0.95, 0.04, 3.0], [0.0, 0.02, 1.05, -1.5]],
    np.float32,
)
TEST_POINTS = np.array([[24, 28, 20], [15, 35, 25], [30, 20, 15]], np.float32)
FFD_POINTS = np.array([[20, 30, 20], [25, 25, 18], [30, 35, 22]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _map(A, pts):
    return pts @ A[:, :3].T + A[:, 3]


def _warped(moving, A, shape):
    """``moving`` pulled back through affine ``A`` onto ``shape`` (port)."""
    return apply_transform_volume(moving, shape, affine_transform_fn(A, CPU), device=CPU)


def _ffd_fixed(moving, seed):
    """The JAX tests' FFD phantom: ``moving`` pulled back through the dense
    field of a random spacing-16 control grid (std 1.6 voxels)."""
    true_field = BSplineField.zeros(moving.shape, spacing=16.0)
    true_field.ctrl = np.random.default_rng(seed).normal(
        0, 1.6, true_field.ctrl.shape).astype(np.float32)
    grid = twarp.fixed_grid(moving.shape, CPU)
    fixed = twarp.sample_volume(_t(moving), grid + true_field.dense_field(CPU)).numpy()
    return fixed, true_field


# ---- functions --------------------------------------------------------------


@pytest.mark.parametrize("case", ["general", "out_of_range", "integer"])
def test_sample_volume_matches_jax(case):
    rng = np.random.default_rng(0)
    vol = (rng.random((9, 11, 13)) * 100).astype(np.float32)
    lo, hi = {"general": (0, 8), "out_of_range": (-3, 16), "integer": (-2, 14)}[case]
    coords = rng.uniform(lo, hi, (2000, 3)).astype(np.float32)
    if case == "integer":
        coords = np.round(coords)
    want = np.asarray(jwarp.sample_volume(jnp.asarray(vol), jnp.asarray(coords)))
    got = twarp.sample_volume(_t(vol), _t(coords)).numpy()
    np.testing.assert_array_equal(got, want)


def test_affine_apply_and_inside_weight_match_jax():
    rng = np.random.default_rng(1)
    coords = rng.uniform(-5, 60, (4000, 3)).astype(np.float32)
    A = TEST_AFFINE
    want = np.asarray(jwarp.affine_apply(jnp.asarray(A), jnp.asarray(coords)))
    got = twarp.affine_apply(_t(A), _t(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    shape = (40, 50, 45)
    np.testing.assert_array_equal(
        twarp.inside_weight(_t(coords), shape).numpy(),
        np.asarray(jwarp.inside_weight(jnp.asarray(coords), shape)))
    np.testing.assert_array_equal(
        twarp.fixed_grid((3, 4, 5), CPU).numpy(), np.asarray(jwarp.fixed_grid((3, 4, 5))))


def test_moments_init_matches_jax():
    moving = _brain_like()
    fixed = _warped(moving, TEST_AFFINE, moving.shape)
    np.testing.assert_array_equal(twarp.moments_init(fixed, moving),
                                  jwarp.moments_init(fixed, moving))


@pytest.mark.parametrize("sim", ["ncc", "mi"])
def test_similarities_match_jax(sim):
    rng = np.random.default_rng(2)
    a = rng.random((16, 18, 20)).astype(np.float32)
    b = (np.sqrt(a) + 0.3 * rng.random(a.shape)).astype(np.float32)
    w = (rng.random(a.shape) > 0.2).astype(np.float32)
    want = float(jaffine.similarity_fn(sim)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)))
    got = float(taffine.similarity_fn(sim)(_t(a), _t(b), _t(w)))
    assert got == pytest.approx(want, rel=1e-5)


def test_axis_basis_and_bending_energy_match_jax():
    for n, c, s in ((20, 6, 8.0), (47, 7, 12.0), (33, 6, 16.0)):
        np.testing.assert_array_equal(tbspline._axis_basis(n, c, s),
                                      jbspline._axis_basis(n, c, s))
    ctrl = np.random.default_rng(3).normal(0, 2, (5, 6, 4, 3)).astype(np.float32)
    assert float(tbspline._bending_energy(_t(ctrl))) == pytest.approx(
        float(jbspline._bending_energy(jnp.asarray(ctrl))), rel=1e-6)


def test_dense_and_points_field_match_jax(monkeypatch):
    """The dense field within 1e-5 of JAX's (full f32 on both sides); the
    point field within 1e-5, chunked or in one call (equal to each other)."""
    field = BSplineField.zeros((20, 24, 16), spacing=8.0)
    field.ctrl = np.random.default_rng(1).normal(0, 2, field.ctrl.shape).astype(np.float32)
    jfield = jbspline.BSplineField(field.spacing, field.fixed_shape, field.ctrl)
    np.testing.assert_allclose(field.dense_field(CPU).numpy(),
                               np.asarray(jfield.dense_field()), rtol=0, atol=1e-5)
    pts = np.random.default_rng(3).uniform(0, 19, (205, 3)).astype(np.float32)
    whole = field.at_points(pts, CPU).numpy()
    np.testing.assert_allclose(whole, np.asarray(jfield.at_points(pts)), rtol=0, atol=1e-5)
    monkeypatch.setattr(tbspline, "_POINTS_CHUNK", 64)  # 3 full + partial
    np.testing.assert_array_equal(field.at_points(pts, CPU).numpy(), whole)
    assert field.at_points(np.zeros((0, 3), np.float32), CPU).shape == (0, 3)


# ---- gradients ---------------------------------------------------------------


def _pair(shape=(10, 12, 14), seed=4):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


def _jax_affine_loss(fixed, moving, sim):
    def loss(A):
        coords = jwarp.affine_apply(A, jwarp.fixed_grid(fixed.shape))
        w = jwarp.inside_weight(coords, moving.shape)
        return -jaffine.similarity_fn(sim)(
            jwarp.sample_volume(jnp.asarray(moving), coords), jnp.asarray(fixed), w)
    return loss


def _port_affine_loss(fixed, moving, sim):
    def loss(A):
        coords = twarp.affine_apply(A, twarp.fixed_grid(fixed.shape, CPU))
        w = twarp.inside_weight(coords, moving.shape)
        return -taffine.similarity_fn(sim)(twarp.sample_volume(_t(moving), coords), _t(fixed), w)
    return loss


@pytest.mark.parametrize("sim", ["ncc", "mi"])
@pytest.mark.parametrize("at", ["identity", "general"])
def test_affine_loss_gradient_matches_jax(sim, at):
    """``identity`` samples at integer coordinates only: every trilinear
    weight ties with clip's lower bound, where JAX passes half the gradient
    (torch.clamp would pass all of it and double the result)."""
    fixed, moving = _pair()
    A = jwarp.identity_affine() if at == "identity" else np.array(
        [[1.02, 0.03, 0, 0.3], [0.01, 0.97, 0.02, -0.4], [0, 0.01, 1.01, 0.2]], np.float32)
    want = np.asarray(jax.grad(_jax_affine_loss(fixed, moving, sim))(jnp.asarray(A)))
    At = _t(A).requires_grad_(True)
    _port_affine_loss(fixed, moving, sim)(At).backward()
    np.testing.assert_allclose(At.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_clip_splits_the_gradient_at_a_tie():
    x = torch.tensor([0.0, 0.5, 1.0, 1.5], requires_grad=True)
    twarp.clip(x, 0.0, 1.0).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray([0.0, 0.5, 1.0, 1.5]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [0.5, 1.0, 0.5, 0.0]


@pytest.mark.parametrize("form", ["dense", "points"])
def test_ffd_loss_gradient_matches_jax(form):
    """d loss / d ctrl of the FFD objective (NCC + bending), through the
    dense field or through the point gather at jittered coordinates."""
    fixed, moving = _pair((16, 18, 14), seed=5)
    shape, spacing, lam = fixed.shape, 8.0, 1e-3
    A = np.array([[1.0, 0.02, 0, 0.5], [0, 0.98, 0.01, -0.3], [0.01, 0, 1.02, 0.2]], np.float32)
    ctrl = np.random.default_rng(6).normal(0, 0.5, (*[int(np.ceil(s / spacing)) + 3 for s in shape], 3)).astype(np.float32)
    coords_f = sample_coords(step_generator(0, 0, 0), shape, 500, CPU).numpy()

    def jloss(c):
        if form == "dense":
            co = jwarp.affine_apply(jnp.asarray(A), jwarp.fixed_grid(shape)) + jbspline._dense_field(c, shape, spacing)
            fv = jnp.asarray(fixed)
        else:
            cf = jnp.asarray(coords_f)
            co = jwarp.affine_apply(jnp.asarray(A), cf) + jbspline._points_field(c, cf, spacing)
            fv = jwarp.sample_volume(jnp.asarray(fixed), cf)
        w = jwarp.inside_weight(co, moving.shape)
        return -jaffine.masked_ncc(jwarp.sample_volume(jnp.asarray(moving), co), fv, w) \
            + lam * jbspline._bending_energy(c)

    ct = _t(ctrl).requires_grad_(True)
    if form == "dense":
        co = twarp.affine_apply(_t(A), twarp.fixed_grid(shape, CPU)) + tbspline._dense_field(ct, shape, spacing)
        fv = _t(fixed)
    else:
        cf = _t(coords_f)
        co = twarp.affine_apply(_t(A), cf) + tbspline._points_field(ct, cf, spacing)
        fv = twarp.sample_volume(_t(fixed), cf)
    w = twarp.inside_weight(co, moving.shape)
    loss = -taffine.masked_ncc(twarp.sample_volume(_t(moving), co), fv, w) \
        + lam * tbspline._bending_energy(ct)
    loss.backward()
    want = np.asarray(jax.grad(jloss)(jnp.asarray(ctrl)))
    assert float(loss.detach()) == pytest.approx(float(jloss(jnp.asarray(ctrl))), abs=1e-6)
    np.testing.assert_allclose(ct.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ---- mirrors of tests/test_registration.py -----------------------------------


def test_affine_recovery():
    moving = _brain_like()
    fixed = _warped(moving, TEST_AFFINE, moving.shape)
    est, ncc = register_affine(fixed, moving, levels=(2, 1), iters=(300, 150), device=CPU)
    assert ncc > 0.995
    err = np.abs(_map(TEST_AFFINE, TEST_POINTS) - _map(est, TEST_POINTS)).max()
    assert err < 1.0, f"max point error {err}"
    # against the JAX package on the same volumes
    jest, jncc = jax_register_affine(fixed, moving, levels=(2, 1), iters=(300, 150))
    assert np.abs(_map(est, TEST_POINTS) - _map(jest, TEST_POINTS)).max() < 0.1
    assert abs(ncc - jncc) < 1e-3


def test_bspline_field_point_vs_dense_consistency():
    field = BSplineField.zeros((20, 24, 16), spacing=8.0)
    rng = np.random.default_rng(1)
    field.ctrl = rng.normal(0, 2, field.ctrl.shape).astype(np.float32)
    dense = field.dense_field(CPU).numpy()
    pts = np.array([[0, 0, 0], [5, 7, 3], [19, 23, 15], [10, 12, 8]], np.float32)
    at = field.at_points(pts, CPU).numpy()
    for p, d in zip(pts.astype(int), at):
        np.testing.assert_allclose(dense[p[0], p[1], p[2]], d, rtol=1e-4, atol=1e-4)


def test_bspline_recovery_improves_over_affine():
    moving = _brain_like(seed=2)
    fixed, true_field = _ffd_fixed(moving, seed=3)
    affine, ncc_aff = register_affine(fixed, moving, levels=(2, 1), iters=(200, 100), device=CPU)
    field, score = register_bspline(fixed, moving, affine, spacing=16.0, iters=200, lr=0.25,
                                    device=CPU)
    grid = twarp.fixed_grid(moving.shape, CPU)
    coords = twarp.affine_apply(_t(affine), grid) + field.dense_field(CPU)
    warped = twarp.sample_volume(_t(moving), coords).numpy()
    mask = fixed > 10

    def ncc(a, b, m):
        a, b = a[m], b[m]
        a = a - a.mean()
        b = b - b.mean()
        return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))

    ncc_ffd = ncc(warped, fixed, mask)
    assert ncc_ffd > ncc_aff
    assert ncc_ffd > 0.99
    true_m = FFD_POINTS + true_field.at_points(FFD_POINTS, CPU).numpy()
    est_m = warp_points(affine, field, FFD_POINTS, device=CPU)
    err = np.abs(true_m - est_m).max()
    assert err < 1.5, f"max point error {err}"
    # against the JAX package from the same affine
    jfield, jscore = jax_register_bspline(fixed, moving, affine, spacing=16.0, iters=200,
                                          lr=0.25)
    assert np.abs(est_m - jax_warp_points(affine, jfield, FFD_POINTS)).max() < 0.1
    assert abs(score - jscore) < 1e-3


def test_bspline_multires_recovery():
    moving = _brain_like(seed=2)
    fixed, true_field = _ffd_fixed(moving, seed=7)
    affine, _ = register_affine(fixed, moving, levels=(2, 1), iters=(200, 100), device=CPU)
    field, _ = register_bspline(fixed, moving, affine, spacing=16.0, levels=(2, 1),
                                iters=(150, 60), lr=0.25, device=CPU)
    true_m = FFD_POINTS + true_field.at_points(FFD_POINTS, CPU).numpy()
    err = np.abs(true_m - warp_points(affine, field, FFD_POINTS, device=CPU)).max()
    assert err < 1.5, f"max point error {err}"


def test_sample_coords_stratified():
    shape = (30, 40, 50)
    n = 1000
    pts = sample_coords(step_generator(0, 0, 0), shape, n, CPU).numpy()
    assert pts.shape[1] == 3
    assert 0.5 * n <= pts.shape[0] <= 2.0 * n
    assert (pts >= 0).all()
    assert (pts <= np.asarray(shape, np.float32) - 1.0).all()
    dims = np.asarray(shape, np.float64)
    scale = (pts.shape[0] / dims.prod()) ** (1.0 / 3.0)
    counts = np.maximum(1, np.round(dims * scale).astype(int))
    cells = np.minimum((pts / (dims / counts)).astype(int), counts - 1)
    lin = np.ravel_multi_index(cells.T, counts)
    assert len(np.unique(lin)) == pts.shape[0]
    # the draw depends on each of (seed, level, step), and repeats for the same
    for other in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        assert not np.array_equal(pts, sample_coords(step_generator(*other), shape, n, CPU).numpy())
    np.testing.assert_array_equal(pts, sample_coords(step_generator(0, 0, 0), shape, n, CPU).numpy())


def test_affine_recovery_sampled():
    moving = _brain_like()
    fixed = _warped(moving, TEST_AFFINE, moving.shape)
    est, ncc = register_affine(fixed, moving, levels=(2, 1), iters=(300, 150), n_samples=1024,
                               device=CPU)
    assert ncc > 0.99
    err = np.abs(_map(TEST_AFFINE, TEST_POINTS) - _map(est, TEST_POINTS)).max()
    assert err < 1.25, f"max point error {err}"
    est2, _ = register_affine(fixed, moving, levels=(2, 1), iters=(300, 150), n_samples=1024,
                              device=CPU)
    np.testing.assert_array_equal(est, est2)


def test_bspline_sampled_recovery():
    moving = _brain_like(seed=2)
    fixed, true_field = _ffd_fixed(moving, seed=3)
    affine, _ = register_affine(fixed, moving, levels=(2, 1), iters=(200, 100), n_samples=1024,
                                device=CPU)
    field, _ = register_bspline(fixed, moving, affine, spacing=16.0, iters=200, lr=0.25,
                                n_samples=1024, device=CPU)
    true_m = FFD_POINTS + true_field.at_points(FFD_POINTS, CPU).numpy()
    err = np.abs(true_m - warp_points(affine, field, FFD_POINTS, device=CPU)).max()
    assert err < 2.0, f"max point error {err}"


def test_warp_points_affine_only():
    affine = np.array([[2.0, 0, 0, 1.0], [0, 0.5, 0, 0], [0, 0, 1.0, -3.0]], np.float32)
    out = warp_points(affine, None, np.array([[1.0, 2.0, 3.0]], np.float32), device=CPU)
    np.testing.assert_allclose(out, [[3.0, 1.0, 0.0]])


# ---- mirror of tests/test_registration_crosscheck.py -------------------------


def test_affine_agrees_with_independent_scipy_registrar():
    shape = (32, 28, 36)
    moving, labels_moving = make_synthetic_atlas(shape, n_regions=8, seed=3)
    A_true = _crosscheck_affine()
    fixed = _warped(moving, A_true, shape)
    A_ours, score_ours = register_affine(fixed, moving, device=CPU)
    A_scipy, score_scipy = _scipy_register(np.asarray(fixed, np.float64),
                                           np.asarray(moving, np.float64))
    assert score_ours > 0.9
    assert score_scipy > 0.9
    pts = sample_brain_points(labels_moving, 500, seed=4).astype(np.float32)
    ours = twarp.affine_apply(_t(A_ours), _t(pts)).numpy()
    indep = (A_scipy[:, :3] @ pts.T + A_scipy[:, 3:4]).T
    true = (A_true[:, :3].astype(np.float64) @ pts.T + A_true[:, 3:4]).T
    assert np.linalg.norm(ours - true, axis=1).mean() < 1.0
    assert np.linalg.norm(indep - true, axis=1).mean() < 1.0
    assert np.linalg.norm(ours - indep, axis=1).mean() < 1.0


# ---- mirrors of tests/test_registration_acceptance.py (synthetic cases) -------

ACC_SHAPE = (48, 40, 56)


@pytest.fixture(scope="module")
def atlas():
    return make_synthetic_atlas(ACC_SHAPE, n_regions=10, seed=1)


def _labels_fixed(labels_moving, tf):
    return np.rint(apply_transform_volume(labels_moving.astype(np.float32), ACC_SHAPE, tf,
                                          device=CPU)).astype(np.int32)


@pytest.mark.slow
def test_affine_registration_acceptance(atlas):
    moving, labels_moving = atlas
    tf_true = affine_transform_fn(_acceptance_affine(), CPU)
    fixed = apply_transform_volume(moving, ACC_SHAPE, tf_true, device=CPU)
    A_est, ncc = register_affine(fixed, moving, device=CPU)
    assert ncc > 0.9
    pts = sample_brain_points(_labels_fixed(labels_moving, tf_true), 800, seed=2)
    m = acceptance_metrics(affine_transform_fn(A_est, CPU), tf_true, pts, labels_moving)
    assert m["point_error_mean"] < 1.0, m
    assert m["region_count_f1"] > 0.97, m


@pytest.mark.slow
def test_affine_ffd_registration_acceptance(atlas):
    moving, labels_moving = atlas
    field_true = BSplineField.zeros(ACC_SHAPE, spacing=12.0)
    field_true.ctrl = np.random.default_rng(5).uniform(
        -1.6, 1.6, field_true.ctrl.shape).astype(np.float32)
    tf_true = affine_ffd_transform_fn(_acceptance_affine(), field_true, CPU)
    fixed = apply_transform_volume(moving, ACC_SHAPE, tf_true, device=CPU)
    A_est, _ = register_affine(fixed, moving, device=CPU)
    field_est, _ = register_bspline(fixed, moving, A_est, spacing=12.0, iters=200, device=CPU)
    pts = sample_brain_points(_labels_fixed(labels_moving, tf_true), 800, seed=3)
    m_affine = acceptance_metrics(affine_transform_fn(A_est, CPU), tf_true, pts, labels_moving)
    m_ffd = acceptance_metrics(affine_ffd_transform_fn(A_est, field_est, CPU), tf_true, pts,
                               labels_moving)
    assert m_ffd["point_error_mean"] < m_affine["point_error_mean"], (m_ffd, m_affine)
    assert m_ffd["point_error_mean"] < 1.5, m_ffd
    assert m_ffd["region_count_f1"] > 0.93, m_ffd


def test_affine_from_landmarks_exact_and_robust():
    A = _acceptance_affine()
    rng = np.random.default_rng(0)
    src = rng.uniform(5, 40, (24, 3)).astype(np.float32)
    dst = twarp.affine_apply(_t(A), _t(src)).numpy()
    np.testing.assert_allclose(affine_from_landmarks(src, dst), A, atol=1e-4)
    dst_bad = dst.copy()
    dst_bad[:3] += rng.uniform(15, 30, (3, 3))
    np.testing.assert_allclose(affine_from_landmarks(src, dst_bad, trim_fraction=0.2), A,
                               atol=1e-3)


def test_read_marker_file_formats(tmp_path):
    mk = tmp_path / "lm.marker"
    mk.write_text(
        "# comment line\n"
        "##x,y,z,radius,shape,name,comment\n"
        "10.5, 20.0, 30.25, 1, 1, L1, \n"
        "4,5,6,1,1,L2,\n"
    )
    pts = read_marker_file(str(mk))
    np.testing.assert_allclose(pts[0], [29.25, 19.0, 9.5])
    np.testing.assert_allclose(pts[1], [5.0, 4.0, 3.0])
    csv = tmp_path / "lm.csv"
    csv.write_text("z,y,x\n1,2,3\n4,5,6\n")
    np.testing.assert_allclose(read_marker_file(str(csv))[0], [1, 2, 3])


def test_stage04_resolves_landmark_mode(tmp_path, atlas):
    from delivr_cfos_tpu_torch.config import AtlasAlignmentConfig
    from delivr_cfos_tpu_torch.pipeline.stage04_atlas_align import resolve_registration

    moving, _ = atlas
    A_true = _acceptance_affine()
    fixed = _warped(moving, A_true, ACC_SHAPE)
    src = np.random.default_rng(1).uniform(8, 36, (12, 3)).astype(np.float32)
    dst = twarp.affine_apply(_t(A_true), _t(src)).numpy()
    lf, af = tmp_path / "brain.csv", tmp_path / "atlas.csv"
    lf.write_text("z,y,x\n" + "\n".join(",".join(map(str, p)) for p in src))
    af.write_text("z,y,x\n" + "\n".join(",".join(map(str, p)) for p in dst))
    aa = AtlasAlignmentConfig(landmarks_hemisphere=True, landmarks_file=str(lf),
                              atlas_landmarks_file=str(af), template_file="")
    affine, field, mode = resolve_registration(aa, fixed, device=CPU)
    assert mode == "landmarks"
    assert field is None
    np.testing.assert_allclose(affine, A_true, atol=1e-3)
    _, _, mode2 = resolve_registration(AtlasAlignmentConfig(landmarks_hemisphere=True), fixed,
                                       device=CPU)
    assert mode2 == "fallback"


@pytest.mark.slow
def test_mi_similarity_recovers_cross_modality_affine(atlas):
    moving, labels_moving = atlas
    tf_true = affine_transform_fn(_acceptance_affine(), CPU)
    fixed = apply_transform_volume(moving, ACC_SHAPE, tf_true, device=CPU)
    fixed_remapped = np.where(fixed > 1.0, 255.0 - fixed * 0.8, 0.0).astype(np.float32)
    A_est, _ = register_affine(fixed_remapped, moving, similarity="mi", levels=(2, 1),
                               iters=(400, 200), lrs=(0.01, 0.004), device=CPU)
    pts = sample_brain_points(_labels_fixed(labels_moving, tf_true), 500, seed=7)
    m = acceptance_metrics(affine_transform_fn(A_est, CPU), tf_true, pts, labels_moving)
    assert m["point_error_mean"] < 2.0, m
    assert m["region_count_f1"] > 0.9, m


@pytest.mark.slow
def test_lsfm_realistic_mi_ffd_acceptance(atlas):
    moving, labels_moving = atlas
    field_true = BSplineField.zeros(ACC_SHAPE, spacing=14.0)
    field_true.ctrl = np.random.default_rng(6).uniform(
        -1.2, 1.2, field_true.ctrl.shape).astype(np.float32)
    tf_true = affine_ffd_transform_fn(_acceptance_affine(), field_true, CPU)
    fixed_clean = apply_transform_volume(moving, ACC_SHAPE, tf_true, device=CPU)
    fov_crop = 0.15
    fixed = lsfm_degrade(fixed_clean, seed=8, fov_crop_z=fov_crop)
    labels_fixed = _labels_fixed(labels_moving, tf_true)
    labels_fixed[: int(ACC_SHAPE[0] * fov_crop)] = 0
    A_est, _ = register_affine(fixed, moving, similarity="mi", levels=(2, 1),
                               iters=(400, 200), lrs=(0.01, 0.004), device=CPU)
    field_est, _ = register_bspline(fixed, moving, A_est, spacing=14.0, iters=200,
                                    similarity="mi", device=CPU)
    pts = sample_brain_points(labels_fixed, 600, seed=11)
    m = acceptance_metrics(affine_ffd_transform_fn(A_est, field_est, CPU), tf_true, pts,
                           labels_moving)
    assert m["point_error_mean"] < 2.5, m
    assert m["region_count_f1"] > 0.88, m


def test_masked_mi_properties():
    rng = np.random.default_rng(0)
    a = _t(rng.random((16, 16, 16)))
    b = _t(rng.random((16, 16, 16)))
    w = torch.ones_like(a)
    self_mi = float(masked_mi(a, a, w))
    assert self_mi > float(masked_mi(a, b, w))
    assert float(masked_mi(a, torch.sqrt(a), w)) > float(masked_mi(a, b, w))


@pytest.mark.slow
def test_multistart_recovers_mirrored_brain(atlas):
    moving, labels_moving = atlas
    F = np.eye(4)
    F[1, 1] = -1.0
    F[1, 3] = ACC_SHAPE[1] - 1.0
    A_m = (np.concatenate([_acceptance_affine(), [[0, 0, 0, 1]]]) @ F)[:3].astype(np.float32)
    tf_true = affine_transform_fn(A_m, CPU)
    fixed = apply_transform_volume(moving, ACC_SHAPE, tf_true, device=CPU)
    A_est, _, flip = register_affine_multistart(fixed, moving, device=CPU)
    assert 1 in flip, f"winner should mirror y, got {flip}"
    pts = sample_brain_points(_labels_fixed(labels_moving, tf_true), 500, seed=9)
    m = acceptance_metrics(affine_transform_fn(A_est, CPU), tf_true, pts, labels_moving)
    assert m["point_error_mean"] < 1.5, m
    assert m["region_count_f1"] > 0.93, m
