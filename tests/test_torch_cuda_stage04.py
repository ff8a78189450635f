"""Stage 4's registration library on the card against the same functions on
the CPU, and the repeatability of its optimizers on the card.

Stage 4 runs no hand-written kernel: sampling, similarities, the B-spline
fields and the Adam loops are plain torch. The elementwise steps round each
operation alone on both devices, so the trilinear sample agrees to the bit;
sums, matmuls and the histogram add in another order on the card, so the
similarities, fields and gradients are held to the CPU within rtol 1e-4.
The dense optimizers have no scatter (the gradient never flows into a
volume) and must repeat bit for bit on the card; the MI histogram and the
sampled FFD's control-point gather accumulate through ``index_put`` with
``accumulate=True``, which sorts its indices on CUDA, and must repeat too.

These tests carry the ``cuda`` marker, skip where there is no card, and
import neither JAX nor the JAX package (run without tests/conftest.py on a
GPU machine):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_stage04.py
"""

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.registration import affine as taffine
from delivr_cfos_tpu_torch.registration import bspline as tbspline
from delivr_cfos_tpu_torch.registration import warp as twarp
from delivr_cfos_tpu_torch.registration.affine import register_affine
from delivr_cfos_tpu_torch.registration.bspline import BSplineField, register_bspline, warp_points
from delivr_cfos_tpu_torch.registration.validate import (
    affine_transform_fn,
    apply_transform_volume,
    make_synthetic_atlas,
)

pytestmark = pytest.mark.cuda

A = np.array([[1.02, 0.03, 0, 0.3], [0.01, 0.97, 0.02, -0.4], [0, 0.01, 1.01, 0.2]], np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _pair(shape=(24, 28, 30), seed=0):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


def _both(fn, *arrays):
    """``fn`` on the CPU tensors and on their card copies; both as numpy."""
    cpu = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]
    return fn(*cpu).numpy(), fn(*[t.cuda() for t in cpu]).cpu().numpy()


@pytest.mark.parametrize("case", ["general", "out_of_range", "integer"])
def test_sample_volume_equals_the_cpu(dev, case):
    rng = np.random.default_rng(1)
    vol = (rng.random((30, 40, 50)) * 100).astype(np.float32)
    coords = rng.uniform(*{"general": (0, 29), "out_of_range": (-4, 55),
                           "integer": (-2, 52)}[case], (200_000, 3)).astype(np.float32)
    if case == "integer":
        coords = np.round(coords)
    cpu, card = _both(twarp.sample_volume, vol, coords)
    np.testing.assert_array_equal(card, cpu)


def test_affine_similarities_and_fields_match_the_cpu(dev):
    rng = np.random.default_rng(2)
    coords = rng.uniform(-5, 300, (100_000, 3)).astype(np.float32)
    cpu, card = _both(twarp.affine_apply, A, coords)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)
    a, b = _pair((40, 50, 60), seed=3)
    w = (rng.random(a.shape) > 0.1).astype(np.float32)
    for sim in ("ncc", "mi"):
        cpu, card = _both(taffine.similarity_fn(sim), a, b, w)
        assert float(card) == pytest.approx(float(cpu), rel=1e-4)
    field = BSplineField.zeros((60, 70, 50), spacing=16.0)
    field.ctrl = rng.normal(0, 2, field.ctrl.shape).astype(np.float32)
    np.testing.assert_allclose(field.dense_field(dev).cpu().numpy(),
                               field.dense_field("cpu").numpy(), rtol=0, atol=1e-4)
    pts = rng.uniform(0, 59, (300_000, 3)).astype(np.float32)
    np.testing.assert_allclose(field.at_points(pts, dev).cpu().numpy(),
                               field.at_points(pts, "cpu").numpy(), rtol=0, atol=1e-4)


def _affine_grad(fixed, moving, sim, device):
    f, m = torch.from_numpy(fixed).to(device), torch.from_numpy(moving).to(device)
    At = torch.from_numpy(A).to(device).requires_grad_(True)
    coords = twarp.affine_apply(At, twarp.fixed_grid(f.shape, device))
    loss = -taffine.similarity_fn(sim)(twarp.sample_volume(m, coords), f,
                                       twarp.inside_weight(coords, m.shape))
    loss.backward()
    return At.grad.cpu().numpy()


@pytest.mark.parametrize("sim", ["ncc", "mi"])
def test_affine_gradient_matches_the_cpu(dev, sim):
    fixed, moving = _pair()
    want = _affine_grad(fixed, moving, sim, "cpu")
    np.testing.assert_allclose(_affine_grad(fixed, moving, sim, dev), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _ffd_grad(fixed, moving, ctrl, device):
    f, m = torch.from_numpy(fixed).to(device), torch.from_numpy(moving).to(device)
    c = torch.from_numpy(ctrl).to(device).requires_grad_(True)
    coords = twarp.affine_apply(torch.from_numpy(A).to(device), twarp.fixed_grid(f.shape, device))
    coords = coords + tbspline._dense_field(c, f.shape, 8.0)
    loss = -taffine.masked_ncc(twarp.sample_volume(m, coords), f,
                               twarp.inside_weight(coords, m.shape))
    (loss + 1e-3 * tbspline._bending_energy(c)).backward()
    return c.grad.cpu().numpy()


def test_ffd_gradient_matches_the_cpu(dev):
    fixed, moving = _pair()
    ctrl = np.random.default_rng(4).normal(
        0, 0.5, (*[int(np.ceil(s / 8.0)) + 3 for s in fixed.shape], 3)).astype(np.float32)
    want = _ffd_grad(fixed, moving, ctrl, "cpu")
    np.testing.assert_allclose(_ffd_grad(fixed, moving, ctrl, dev), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def phantom():
    moving, _ = make_synthetic_atlas((40, 36, 44), n_regions=10, seed=1)
    fixed = apply_transform_volume(moving, (44, 40, 48), affine_transform_fn(A, "cpu"),
                                   device="cpu")
    return fixed, moving


@pytest.mark.parametrize("similarity", ["ncc", "mi"])
def test_dense_affine_and_ffd_repeat_bit_for_bit(dev, phantom, similarity):
    fixed, moving = phantom
    runs = []
    for _ in range(2):
        aff, score = register_affine(fixed, moving, similarity=similarity, device=dev)
        field, fscore = register_bspline(fixed, moving, aff, iters=60, similarity=similarity,
                                         device=dev)
        runs.append((aff, score, field.ctrl, fscore))
    (a0, s0, c0, f0), (a1, s1, c1, f1) = runs
    assert a0.tobytes() == a1.tobytes() and s0 == s1
    assert c0.tobytes() == c1.tobytes() and f0 == f1
    # and the card's registration agrees with the CPU's on the test points
    cpu_aff, _ = register_affine(fixed, moving, similarity=similarity, device="cpu")
    pts = np.array([[20, 20, 24], [10, 30, 12], [30, 12, 36]], np.float32)
    assert np.abs(warp_points(a0, None, pts, device="cpu")
                  - warp_points(cpu_aff, None, pts, device="cpu")).max() < 0.1


def test_sampled_paths_repeat_bit_for_bit(dev, phantom):
    fixed, moving = phantom
    runs = []
    for _ in range(2):
        aff, _ = register_affine(fixed, moving, levels=(2, 1), iters=(60, 40), n_samples=512,
                                 device=dev)
        field, _ = register_bspline(fixed, moving, aff, iters=40, n_samples=512, device=dev)
        runs.append((aff, field.ctrl))
    assert runs[0][0].tobytes() == runs[1][0].tobytes()
    assert runs[0][1].tobytes() == runs[1][1].tobytes()
