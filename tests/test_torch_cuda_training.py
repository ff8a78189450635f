"""Training on the card. Marker ``cuda``; skips without a card; imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_training.py

- The step's backward runs in true float32: its decoder's gradients sit
  far closer to the CPU's (which has no TF32) than those of the same step
  with its backward left to cuDNN's TF32 default.
- Three Adam steps on the card against three on the CPU from the same
  weights, at the TINY width, with the CPU tests' bounds
  (tests/test_torch_training.py).
- The dp×sp step over four distinct cards, where four are present, against
  one card: the loss within rtol 1e-4, the decoder's gradients within 1e-4
  of each tensor's max |g|, the encoder's (behind a max-pool) within 1e-3.
"""

import time

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig
from delivr_cfos_tpu_torch.parallel.mesh import make_mesh
from delivr_cfos_tpu_torch.training import TrainConfig, make_train_step
from delivr_cfos_tpu_torch.training.losses import dice_bce_loss

pytestmark = pytest.mark.cuda

TINY = (4, 4, 8, 16, 32, 4)
MID = (16, 16, 32, 64, 128, 16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) * 100).astype(np.float32)
    return x, (x > 80).astype(np.float32)


def _states(features, device, lr=1e-3):
    """(model, optimizer, step) on ``device`` from the seed-0 weights."""
    init_state, step = make_train_step(
        TrainConfig(model=BasicUNetConfig(features=features), learning_rate=lr), device=device)
    model, optimizer = init_state()
    return model, optimizer, step


def _grad_err(model, ref) -> float:
    """The largest gradient error over the decoder, each tensor's relative
    to its max |g| on the CPU (the pre-InstanceNorm conv biases, true
    gradient 0, left out). The encoder's gradients flow back through
    max-pools, where a near-tie that rounds the other way on the card sends
    a gradient to another voxel."""
    out = 0.0
    for (n, p), q in zip(model.named_parameters(), ref.parameters()):
        if not n.endswith(".conv.bias") and not n.startswith(("conv_0.", "down_")):
            out = max(out, float((p.grad.cpu() - q.grad).abs().max() / q.grad.abs().max()))
    return out


def test_backward_runs_in_full_f32(dev):
    x, y = _batch((2, 32, 32, 32, 1))
    cpu, cpu_opt, cpu_step = _states(MID, "cpu")
    cpu_step(cpu, cpu_opt, x, y)
    card, card_opt, card_step = _states(MID, dev)
    card_step(card, card_opt, x, y)
    f32_err = _grad_err(card, cpu)

    tf32, _, _ = _states(MID, dev)  # forward in full f32, backward in TF32
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        loss = dice_bce_loss(tf32(torch.from_numpy(x).to(dev)), torch.from_numpy(y).to(dev))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        loss.backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    tf32_err = _grad_err(tf32, cpu)
    print(f"gradient error against the CPU: full f32 {f32_err:.3g}, TF32 backward {tf32_err:.3g}")
    assert f32_err <= 1e-4
    assert tf32_err > 10 * f32_err


def test_card_steps_as_the_cpu_does(dev):
    x, y = _batch((2, 32, 32, 32, 1), seed=1)
    lr, steps = 1e-3, 3
    cpu, cpu_opt, cpu_step = _states(TINY, "cpu", lr)
    card, card_opt, card_step = _states(TINY, dev, lr)
    grads, losses = [], []
    for _ in range(steps):
        losses.append(float(card_step(card, card_opt, x, y)))
        cpu_loss = float(cpu_step(cpu, cpu_opt, x, y))
        np.testing.assert_allclose(losses[-1], cpu_loss, rtol=1e-5)
        grads.append({n: p.grad.clone() for n, p in cpu.named_parameters()})
    for (n, p), q in zip(card.named_parameters(), cpu.parameters()):
        err = (p.detach().cpu() - q.detach()).abs()
        rel = torch.stack([g[n].abs() / g[n].abs().max() for g in grads])
        near_zero = (rel.min(0).values < 1e-3) | n.endswith(".conv.bias")
        assert float(torch.where(near_zero, 0.0, err).max()) <= 1e-5, n
        assert float(err.max()) <= 2 * lr * steps, n


def test_sharded_step_over_four_cards(dev):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    x, y = _batch((2, 64, 96, 96, 1), seed=2)
    cfg = TrainConfig(model=BasicUNetConfig())
    init_1, step_1 = make_train_step(cfg, device="cuda:0")
    one, one_opt = init_1()
    loss_1 = float(step_1(one, one_opt, x, y))
    mesh = make_mesh({"dp": 2, "sp": 2}, devices=[f"cuda:{i}" for i in range(4)])
    init_s, step_s = make_train_step(cfg, mesh)
    model, optimizer = init_s()
    loss = float(step_s(model, optimizer, x, y))
    np.testing.assert_allclose(loss, loss_1, rtol=1e-4)
    # behind a max-pool (the encoder) a near-tie that rounds the other way
    # sends a gradient to another voxel: 6.7e-5 of max |g| at this shape on
    # one card named four times, 3.5e-3 on the CPU
    top = max(float(p.grad.abs().max()) for p in one.parameters())
    errs = {}
    for (n, p), q in zip(model.named_parameters(), one.parameters()):
        scale = top if n.endswith(".conv.bias") else float(q.grad.abs().max())
        errs[n] = float((p.grad.to(q.grad.device) - q.grad).abs().max()) / scale
    encoder = {n: e for n, e in errs.items() if n.startswith(("conv_0.", "down_"))}
    decoder = {n: e for n, e in errs.items() if n not in encoder}
    secs = []
    for fn, m, o in ((step_1, one, one_opt), (step_s, model, optimizer)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(m, o, x, y)  # a second step, timed
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print(f"four cards against one: loss {abs(loss - loss_1) / abs(loss_1):.3g}, "
          f"gradients: decoder {max(decoder.values()):.3g}, "
          f"encoder {max(encoder.values()):.3g}; seconds a step: one card "
          f"{secs[0]:.4f}, four {secs[1]:.4f}")
    for n, e in decoder.items():
        assert e <= 1e-4, (n, e)
    for n, e in encoder.items():
        assert e <= 1e-3, (n, e)
