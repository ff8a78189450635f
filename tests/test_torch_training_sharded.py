"""The port's dp×sp train step (``delivr_cfos_tpu_torch/parallel/
sharded_training.py``) against the JAX package's sharded step and the
port's single-device step, on meshes of CPU devices.

Mirrors ``test_train_step_sharded_matches_unsharded_loss`` of
tests/test_training.py: {"dp": 2, "sp": 4} at (2, 64, 16, 16, 1), the loss
within rtol 1e-4 of JAX's step sharded over its eight virtual devices
(tests/conftest.py) and of the port's single-device step, each gradient
within 1e-4 of its tensor's max |g| (the 18 pre-InstanceNorm conv biases,
whose true gradient is 0, within 1e-4 of the model's largest). A mesh of
``"cpu"`` and ``"cpu:0"``, which torch counts as two devices, holds two
replicas, so the replicas' gradient sum and refresh run here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delivr_cfos_tpu.models.basic_unet import BasicUNetConfig as JaxConfig
from delivr_cfos_tpu.parallel.mesh import make_mesh as jax_make_mesh
from delivr_cfos_tpu.training import TrainConfig as JaxTrainConfig
from delivr_cfos_tpu.training import make_train_step as jax_make_train_step
from delivr_cfos_tpu.training.train import make_optimizer as jax_make_optimizer
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig
from delivr_cfos_tpu_torch.models.convert import jax_params_from_state_dict
from delivr_cfos_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh
from delivr_cfos_tpu_torch.parallel.sharded_training import mesh_grid, split_batch
from delivr_cfos_tpu_torch.training import TrainConfig, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
CFG = TrainConfig(model=BasicUNetConfig(features=TINY), learning_rate=1e-3)


def _batch(shape=(2, 64, 16, 16, 1), seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = (rng.random(shape) > 0.9).astype(np.float32)
    return x, y


def _grads(model) -> dict:
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def assert_grads_close(got: dict, want: dict):
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        scale = top if name.endswith(".conv.bias") else float(g.abs().max())
        err = float((got[name] - g).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.fixture(scope="module")
def single_step():
    """The port's single-device step from CFG's initial weights: (initial
    state dict, loss, gradients)."""
    init_state, step = make_train_step(CFG, device="cpu")
    model, optimizer = init_state()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = _batch()
    loss = float(step(model, optimizer, x, y))
    return sd, loss, _grads(model)


def test_sharded_step_matches_jax_sharded_and_single_device(single_step):
    sd, loss_1, grads_1 = single_step
    x, y = _batch()
    mesh = make_mesh({"dp": 2, "sp": 4}, devices=["cpu"] * 8)
    init_state, step = make_train_step(CFG, mesh)
    model, optimizer = init_state()
    assert all(torch.equal(a, sd[n]) for n, a in model.state_dict().items())
    loss = float(step(model, optimizer, x, y))

    # JAX's sharded step over its 8 virtual devices, on the same weights
    jcfg = JaxTrainConfig(model=JaxConfig(features=TINY), learning_rate=1e-3)
    _, jax_step = jax_make_train_step(jcfg, jax_make_mesh({"dp": 2, "sp": 4}))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params_from_state_dict(sd))
    _, _, jax_loss = jax_step(params, jax_make_optimizer(jcfg).init(params),
                              jnp.asarray(x), jnp.asarray(y))

    np.testing.assert_allclose(loss, float(jax_loss), rtol=1e-4)
    np.testing.assert_allclose(loss, loss_1, rtol=1e-4)
    assert_grads_close(_grads(model), grads_1)


@pytest.mark.parametrize("devices,sizes", [
    (["cpu", "cpu:0", "cpu", "cpu:0"], {"dp": 2, "sp": 2}),
    (["cpu", "cpu:0"], {"sp": 2}),
])
def test_two_replicas_step_as_one_device(single_step, devices, sizes):
    """Three steps over a mesh of two distinct devices (two replicas): the
    first step's gradients, summed over the replicas, and every step's loss
    against single-device steps. A replica left with the old weights would
    part the later losses by far more than the bound (an Adam step at lr
    1e-3 moves the loss by about 1e-2)."""
    sd, loss_1, grads_1 = single_step
    x, y = _batch()
    _, step = make_train_step(CFG, make_mesh(sizes, devices=devices))
    init_1, step_1 = make_train_step(CFG, device="cpu")
    m1, o1 = init_1()
    model, optimizer = init_1()
    losses = [float(step(model, optimizer, x, y))]
    assert_grads_close(_grads(model), grads_1)
    losses += [float(step(model, optimizer, x, y)) for _ in range(2)]
    losses_1 = [float(step_1(m1, o1, x, y)) for _ in range(3)]
    assert losses_1[0] == loss_1 and abs(losses_1[2] - losses_1[0]) > 1e-3
    np.testing.assert_allclose(losses, losses_1, rtol=1e-4)


def test_hybrid_mesh_is_a_train_mesh():
    mesh = make_hybrid_mesh(n_slices=2, devices=["cpu"] * 8)
    assert mesh.axis_names == ("dp", "sp")
    grid = mesh_grid(mesh)
    assert grid.shape == (2, 4)
    x, _ = _batch()
    shards = split_batch(x, grid)
    assert [[tuple(t.shape) for t in row] for row in shards] == [[(1, 1, 16, 16, 16)] * 4] * 2
    np.testing.assert_array_equal(shards[1][2].numpy()[0, 0], x[1, 32:48, ..., 0])


def test_shapes_that_do_not_split_raise():
    mesh = make_mesh({"dp": 2, "sp": 4}, devices=["cpu"] * 8)
    _, step = make_train_step(CFG, mesh)
    init_state, _ = make_train_step(CFG, device="cpu")
    model, optimizer = init_state()
    with pytest.raises(ValueError, match="16·sp"):
        step(model, optimizer, *_batch((2, 48, 16, 16, 1)))
    with pytest.raises(ValueError, match="dp=2"):
        step(model, optimizer, *_batch((3, 64, 16, 16, 1)))
    with pytest.raises(ValueError, match="'dp' and 'sp'"):
        make_train_step(CFG, make_mesh({"x": 2}, devices=["cpu"] * 2))
