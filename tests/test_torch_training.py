"""The port's training slice (``delivr_cfos_tpu_torch/training/``) against the
JAX package's (``delivr_cfos_tpu/training/``), on the CPU at the TINY width.

Mirrors tests/test_training.py case by case, and holds the pieces to JAX:
the losses and their gradients against ``jax.grad`` (JAX's rules at a logit
of exactly 0 included), the patch loader's batches value for value, and one
train step from JAX's initial weights (carried across with
``state_dict_from_jax_params``): loss within rtol 1e-5, each gradient within
1e-4 of its tensor's max |g|. The 18 conv biases ahead of an InstanceNorm
have a true gradient of 0 (the norm subtracts the mean): both frameworks
give rounding noise there, held to 1e-4 of the model's largest gradient, and
Adam turns that noise into about ±lr a step, so after three Adam or AdamW
steps those biases are held to 2·lr·steps and every other parameter to
1e-5. Adam amplifies rounding in the same way wherever a gradient is near
0: an element whose gradient at some step is under 1e-3 of its tensor's max
|g| (update ≈ lr·δg/|g|) is held to the biases' bound, and such elements
must stay under a tenth of the parameters. The optimizer itself is held
apart from that rounding: fed JAX's own gradients, Adam and AdamW give
optax's parameters within 1e-6, every element included.
"""

import glob
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from delivr_cfos_tpu.models.basic_unet import BasicUNetConfig as JaxConfig
from delivr_cfos_tpu.models.basic_unet import basic_unet_apply as jax_apply
from delivr_cfos_tpu.models.basic_unet import init_params
from delivr_cfos_tpu.models.convert import load_params_npz as jax_load_params_npz
from delivr_cfos_tpu.training import TrainConfig as JaxTrainConfig
from delivr_cfos_tpu.training import losses as jlosses
from delivr_cfos_tpu.training import make_train_step as jax_make_train_step
from delivr_cfos_tpu.training.data import batch_iterator as jax_batch_iterator
from delivr_cfos_tpu.training.data import list_patch_pairs as jax_list_patch_pairs
from delivr_cfos_tpu.training.train import make_optimizer as jax_make_optimizer
from delivr_cfos_tpu.utils.io.nifti import write_nifti_raw
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig
from delivr_cfos_tpu_torch.models.convert import (
    jax_params_from_state_dict,
    load_weights,
    state_dict_from_jax_params,
)
from delivr_cfos_tpu_torch.training import TrainConfig, make_train_step, train
from delivr_cfos_tpu_torch.training import losses as plosses
from delivr_cfos_tpu_torch.training.data import batch_iterator, list_patch_pairs, load_patch_pair
from delivr_cfos_tpu_torch.training.train import (
    export_npz,
    restore_checkpoint,
    save_checkpoint,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
STEPS = 3
LR = 1e-3


def _toy_batches(seed=0):
    """tests/test_training.py's toy batches."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.random((2, 16, 16, 16, 1)).astype(np.float32) * 100
        y = (x > 80).astype(np.float32)
        yield x, y


def pre_in_bias(name: str) -> bool:
    """The 18 conv biases ahead of an InstanceNorm."""
    return name.endswith(".conv.bias")


def jax_tree_to_sd(tree) -> dict:
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def assert_grads_close(got: dict, want: dict):
    """Each gradient within 1e-4 of its tensor's max |g|; the pre-IN biases
    (true gradient 0) within 1e-4 of the model's largest."""
    top = max(float(g.abs().max()) for g in want.values())
    assert sum(map(pre_in_bias, want)) == 18
    for name, g in want.items():
        scale = top if pre_in_bias(name) else float(g.abs().max())
        err = float((got[name] - g).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


# --- losses ------------------------------------------------------------------


def _logits(seed=0, shape=(2, 6, 5, 4, 1)):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(shape) * 4).astype(np.float32)
    z.flat[::7] = 0.0  # JAX's gradient rules at exactly 0
    t = (rng.random(shape) > 0.6).astype(np.float32)
    return z, t


@pytest.mark.parametrize("name", ["dice_loss", "bce_loss", "dice_bce_loss"])
def test_losses_and_their_gradients_match_jax(name):
    z, t = _logits()
    jfn, pfn = getattr(jlosses, name), getattr(plosses, name)
    jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(z), jnp.asarray(t))
    zt = torch.from_numpy(z).requires_grad_()
    val = pfn(zt, torch.from_numpy(t))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-9)


def test_dice_is_one_ratio_over_the_whole_batch_and_the_sums_agree():
    """Dice over the whole batch, not a mean of per-sample Dice; the sharded
    step's ``dice_bce_from_sums`` over the pieces' ``loss_sums`` gives
    ``dice_bce_loss``, weights included."""
    z, t = _logits(seed=1)
    t[1] = 0  # a sample without foreground
    zt, tt = torch.from_numpy(z), torch.from_numpy(t)
    per_sample = np.mean([float(plosses.dice_loss(zt[i:i + 1], tt[i:i + 1])) for i in range(2)])
    assert abs(float(plosses.dice_loss(zt, tt)) - per_sample) > 0.03
    sums = plosses.loss_sums(zt[:1], tt[:1]) + plosses.loss_sums(zt[1:], tt[1:])
    for wd, wb in ((1.0, 1.0), (0.3, 2.0)):
        np.testing.assert_allclose(
            float(plosses.dice_bce_from_sums(sums, z.size, wd, wb)),
            float(jlosses.dice_bce_loss(jnp.asarray(z), jnp.asarray(t), wd, wb)), rtol=1e-6)


# --- the patch loader --------------------------------------------------------


@pytest.fixture(scope="module")
def patch_root(tmp_path_factory):
    """Seeded patches in the reference's layout: float64 raw, uint8 gt, one
    RGB-coded gt, one raw without gt, one .nii among the .nii.gz."""
    root = tmp_path_factory.mktemp("patches")
    rng = np.random.default_rng(5)
    os.makedirs(root / "raw")
    os.makedirs(root / "gt")
    for i in range(4):
        raw = rng.random((20, 18, 16)) * 500
        gt = (raw > 420).astype(np.uint8)
        ext = ".nii" if i == 2 else ".nii.gz"
        write_nifti_raw(str(root / "raw" / f"patchvolume_{i}{ext}"), raw)
        if i == 1:
            gt = np.stack([gt * 255, np.zeros_like(gt), gt * 7], axis=-1)
        if i != 3:
            write_nifti_raw(str(root / "gt" / f"patchvolume_{i}{ext}"), gt)
    return str(root)


def test_patch_pairs_and_rgb_gt_match_jax(patch_root):
    pairs = list_patch_pairs(patch_root)
    assert pairs == jax_list_patch_pairs(patch_root)
    assert len(pairs) == 3
    raw, gt = load_patch_pair(*pairs[1])
    assert raw.dtype == np.float32 and gt.dtype == np.uint8 and gt.shape == raw.shape
    assert set(np.unique(gt)) == {0, 1}


@pytest.mark.parametrize("crop", [(8, 8, 8), (20, 5, 16), None])
def test_batch_iterator_gives_jax_batches(patch_root, crop):
    pairs = list_patch_pairs(patch_root)
    ours = batch_iterator(pairs, batch_size=3, crop=crop, seed=7)
    theirs = jax_batch_iterator(pairs, batch_size=3, crop=crop, seed=7)
    for _ in range(4):
        (x, y), (jx, jy) = next(ours), next(theirs)
        assert x.dtype == np.float32 and y.dtype == np.float32
        assert x.shape == (3, *(crop or (20, 18, 16)), 1)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


# --- the train step against JAX's -------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """From JAX's initial weights on the toy batch: the first loss and
    gradients, and for Adam and AdamW three steps of JAX's train step with
    each step's gradients."""
    x, y = next(_toy_batches())
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jcfg = JaxConfig(features=TINY)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jlosses.dice_bce_loss(jax_apply(p, xj, jcfg), yj)))
    runs = {}
    for opt, wd in (("adam", 0.0), ("adamw", 1e-2)):
        tcfg = JaxTrainConfig(model=jcfg, learning_rate=LR, weight_decay=wd)
        _, step = jax_make_train_step(tcfg)
        # init_state()'s weights, drawn in one jitted call (eager: 40 s)
        params = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(tcfg.seed), jcfg)
        opt_state = jax_make_optimizer(tcfg).init(params)
        init = jax_tree_to_sd(params)
        grads, losses = [], []
        for _ in range(STEPS):
            loss, g = grad_fn(params)
            grads.append(jax_tree_to_sd(g))
            losses.append(float(loss))
            params, opt_state, _ = step(params, opt_state, xj, yj)
        runs[opt] = dict(init=init, grads=grads, losses=losses, final=jax_tree_to_sd(params),
                         weight_decay=wd)
    return x, y, runs


def _port_state(init_sd, weight_decay=0.0):
    cfg = TrainConfig(model=BasicUNetConfig(features=TINY), learning_rate=LR,
                      weight_decay=weight_decay)
    init_state, step = make_train_step(cfg, device="cpu")
    model, optimizer = init_state()
    model.load_state_dict(init_sd)
    return model, optimizer, step


def test_one_step_matches_jax_loss_and_gradients(jax_runs):
    x, y, runs = jax_runs
    run = runs["adam"]
    model, optimizer, step = _port_state(run["init"])
    loss = step(model, optimizer, x, y)
    np.testing.assert_allclose(float(loss), run["losses"][0], rtol=1e-5)
    assert_grads_close({n: p.grad for n, p in model.named_parameters()}, run["grads"][0])


def test_every_parameter_gets_a_gradient():
    """The 36 InstanceNorm scale and bias tensors included (at 32³ the
    bottom level keeps 2³ voxels: at 16³ its single voxel makes the norm's
    output its bias, and its scale's gradient 0)."""
    cfg = TrainConfig(model=BasicUNetConfig(features=TINY))
    init_state, step = make_train_step(cfg, device="cpu")
    model, optimizer = init_state()
    rng = np.random.default_rng(2)
    x = rng.random((1, 32, 32, 32, 1)).astype(np.float32)
    step(model, optimizer, x, (x > 0.8).astype(np.float32))
    norms = [(n, p) for n, p in model.named_parameters() if ".adn.N." in n]
    assert len(norms) == 36
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    for n, p in norms:
        assert float(p.grad.abs().max()) > 0, n


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_three_steps_match_jax_parameters(jax_runs, opt):
    x, y, runs = jax_runs
    run = runs[opt]
    model, optimizer, step = _port_state(run["init"], run["weight_decay"])
    assert type(optimizer).__name__ == {"adam": "Adam", "adamw": "AdamW"}[opt]
    losses = [float(step(model, optimizer, x, y)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    noisy = total = 0
    for name, p in model.named_parameters():
        want = run["final"][name]
        err = (p.detach() - want).abs()
        rel = torch.stack([g[name].abs() / g[name].abs().max() for g in run["grads"]])
        near_zero = (rel.min(0).values < 1e-3) | pre_in_bias(name)
        total += p.numel()
        noisy += int(near_zero.sum()) if not pre_in_bias(name) else 0
        assert float(torch.where(near_zero, 0.0, err).max()) <= 1e-5, name
        assert float(err.max()) <= 2 * LR * STEPS, name
    assert noisy < total / 10


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_optimizer_steps_as_optax_on_jax_gradients(jax_runs, opt):
    """The optimizer apart from the gradients' rounding: JAX's gradients of
    each step go into the port's Adam/AdamW (as ``p.grad``, then
    ``step()``) and into optax; every element, the pre-IN biases and the
    near-zero gradients included, ends within 1e-6 of optax's."""
    _, _, runs = jax_runs
    run = runs[opt]
    jopt = jax_make_optimizer(JaxTrainConfig(model=JaxConfig(features=TINY), learning_rate=LR,
                                             weight_decay=run["weight_decay"]))

    def as_jax(sd):
        return jax.tree_util.tree_map(jnp.asarray, jax_params_from_state_dict(sd))

    params = as_jax(run["init"])
    opt_state = jopt.init(params)
    model, optimizer, _ = _port_state(run["init"], run["weight_decay"])
    for g in run["grads"]:
        updates, opt_state = jopt.update(as_jax(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, p in model.named_parameters():
            p.grad = g[name].clone()
        optimizer.step()
    want = jax_tree_to_sd(params)
    for name, p in model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-6, (name, err)


def test_train_step_reduces_loss():
    cfg = TrainConfig(model=BasicUNetConfig(features=TINY), learning_rate=3e-3)
    init_state, step = make_train_step(cfg, device="cpu")
    model, optimizer = init_state()
    x, y = next(_toy_batches())
    losses = [float(step(model, optimizer, x, y)) for _ in range(12)]
    assert losses[-1] < losses[0]


def test_refuses_the_fused_epilogue_and_fast_mode():
    for mcfg in (BasicUNetConfig(features=TINY, fused_in_mish=True),
                 BasicUNetConfig(features=TINY, precision="fast")):
        with pytest.raises(ValueError, match="no backward"):
            make_train_step(TrainConfig(model=mcfg), device="cpu")


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device None is the card here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(TrainConfig(model=BasicUNetConfig(features=TINY)))


# --- checkpoints and export --------------------------------------------------


def test_checkpoint_save_restore_resume(tmp_path):
    """Save mid-run, restore exactly, resume: the restored state steps as
    the in-memory one does, to the bit."""
    cfg = TrainConfig(model=BasicUNetConfig(features=(2, 2, 4, 8, 16, 2)))
    init_state, step = make_train_step(cfg, device="cpu")
    model, optimizer = init_state()
    rng = np.random.default_rng(0)
    x = rng.random((1, 16, 16, 16, 1)).astype(np.float32)
    y = (rng.random((1, 16, 16, 16, 1)) > 0.9).astype(np.float32)
    step(model, optimizer, x, y)

    ckpt = str(tmp_path / "ckpts")
    assert restore_checkpoint(ckpt, init_state)[2] == 0
    path = save_checkpoint(ckpt, 1, model, optimizer)
    assert os.path.basename(path) == "step_00000001"
    assert sorted(os.listdir(ckpt)) == ["step_00000001"]  # no temporary left
    m2, o2, s = restore_checkpoint(ckpt, init_state)
    assert s == 1
    for (n, a), b in zip(model.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n
    la, lb = step(model, optimizer, x, y), step(m2, o2, x, y)
    assert float(la) == float(lb)
    for a, b in zip(model.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_train_resumes_from_its_checkpoints(tmp_path):
    """``train`` stopped after step 2 and run again to step 5 over the rest
    of the batches gives the uninterrupted run's parameters, and prints
    JAX's lines."""
    cfg = TrainConfig(model=BasicUNetConfig(features=TINY), learning_rate=3e-3)
    batches = list(zip(range(5), _toy_batches(3)))
    whole = train(cfg, (b for _, b in batches), 5, log_every=1, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    train(cfg, (b for _, b in batches[:2]), 2, log_every=1, ckpt_dir=ckpt,
          ckpt_every=1, device="cpu")
    assert sorted(os.listdir(ckpt)) == ["step_00000001", "step_00000002"]
    out = io.StringIO()
    with redirect_stdout(out):
        resumed = train(cfg, (b for _, b in batches[2:]), 5, log_every=1, ckpt_dir=ckpt,
                        ckpt_every=10, device="cpu")
    lines = out.getvalue().splitlines()
    assert lines[0] == "resumed from step 2"
    assert [ln.split(":")[0] for ln in lines[1:]] == ["step 2", "step 3", "step 4"]
    assert sorted(os.listdir(ckpt))[-1] == "step_00000005"
    for (n, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n


def test_export_npz_is_read_by_jax_and_gives_its_forward(tmp_path, jax_runs):
    x, y, runs = jax_runs
    model, optimizer, step = _port_state(runs["adam"]["init"])
    step(model, optimizer, x, y)
    path = export_npz(model, str(tmp_path / "weights.npz"))
    jparams = jax_load_params_npz(path)
    ours = jax_params_from_state_dict(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(ours)
    assert len(flat) == len(jax.tree_util.tree_leaves(jparams)) == 82
    for keys, leaf in flat:
        node = jparams
        for k in keys:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), leaf)
    assert all(torch.equal(a, load_weights(path)[n]) for n, a in model.state_dict().items())
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_apply, static_argnums=2)(
        jparams, jnp.asarray(x), JaxConfig(features=TINY)))
    np.testing.assert_allclose(logits, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert not glob.glob(str(tmp_path / "*.tmp"))
