"""BasicUNet training: Adam steps on one device, or over a ('dp', 'sp') mesh
(data parallel over the batch, spatial parallel over z).

The port's counterpart of ``delivr_cfos_tpu/training/train.py``: optax's
Adam becomes ``torch.optim.Adam`` (AdamW with ``weight_decay``), orbax's
checkpoints become ``torch.save`` of the model's and the optimizer's state
dicts, and the jitted, sharded step becomes ``parallel/sharded_training.py``.
The forward is the parity f32 BasicUNet, forward and backward in true
float32 (no TF32), as the JAX step runs at precision 'highest'. The fast
forward and the fused InstanceNorm+mish run hand-written kernels that have no
backward (in the JAX package their Pallas kernels have none either), so
training refuses them. ``export_npz`` writes the weights in the ``.npz``
format the JAX package's ``load_params_npz`` and the port's ``load_weights``
read, for stage 2.

Initial weights come from ``init_state_dict`` with a ``torch.Generator``
seeded from ``TrainConfig.seed``: JAX's distributions, not its draws.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.nn as nn

from delivr_cfos_tpu_torch.models.basic_unet import BasicUNet, BasicUNetConfig, init_state_dict
from delivr_cfos_tpu_torch.models.convert import jax_params_from_state_dict, save_params_npz
from delivr_cfos_tpu_torch.parallel.mesh import Mesh
from delivr_cfos_tpu_torch.training.losses import dice_bce_loss
from delivr_cfos_tpu_torch.utils.device import full_f32, resolve_device


@dataclass(frozen=True)
class TrainConfig:
    model: BasicUNetConfig = BasicUNetConfig()
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    seed: int = 0


def make_optimizer(cfg: TrainConfig, params):
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8), or ``adamw`` (decay
    decoupled, on every parameter) where ``cfg.weight_decay`` is set."""
    if cfg.weight_decay:
        return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _check_trainable(model_cfg: BasicUNetConfig) -> None:
    if not isinstance(model_cfg, BasicUNetConfig):
        raise NotImplementedError(f"training runs BasicUNet alone, not "
                                  f"{type(model_cfg).__name__}")
    if model_cfg.fused_in_mish:
        raise ValueError("fused_in_mish cannot train: the instance_norm_mish kernel has "
                         "no backward (nor has its Pallas counterpart in the JAX package)")
    if model_cfg.precision != "parity":
        raise ValueError(f"precision {model_cfg.precision!r} cannot train: the fast "
                         "forward's conv3d_cs and deconv2x_cs kernels have no backward (nor "
                         "has the Pallas conv3d_cs in the JAX package); train in 'parity'")


def _batch(a, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.float32)


def make_train_step(cfg: TrainConfig, mesh: Mesh | None = None, device=None):
    """Returns (init_state, step). ``init_state()`` gives (model, optimizer)
    on the device; ``step(model, optimizer, x, y)`` takes (N, D, H, W, 1)
    float32 tensors or arrays, updates the model in place and returns the
    loss. ``device`` None means the card (raises without CUDA); with a
    ``mesh`` the model lives on its first device and x/y split (dp, sp)."""
    _check_trainable(cfg.model)
    if mesh is not None:
        # imported here: sharded_training imports this package's losses
        from delivr_cfos_tpu_torch.parallel.sharded_training import make_sharded_step

        device = resolve_device(mesh.devices.flat[0])
        step = make_sharded_step(mesh)
    else:
        device = resolve_device(device)

        def step(model, optimizer, x, y):
            x, y = _batch(x, device), _batch(y, device)
            optimizer.zero_grad(set_to_none=True)
            with full_f32():  # the backward's convs too
                loss = dice_bce_loss(model(x), y)
                loss.backward()
            optimizer.step()
            return loss.detach()

    def init_state():
        model = BasicUNet(cfg.model)
        model.load_state_dict(init_state_dict(cfg.model, torch.Generator().manual_seed(cfg.seed)))
        model = model.to(device).train()
        return model, make_optimizer(cfg, model.parameters())

    return init_state, step


def save_checkpoint(ckpt_dir: str, step: int, model: nn.Module, optimizer) -> str:
    """``torch.save`` of {model, optimizer, step} as ``ckpt_dir/step_{step:08d}``,
    written under a temporary name and renamed, so a crash leaves no partial
    entry. The inference-side weight format stays the ``.npz`` (``export_npz``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    path, tmp = os.path.join(ckpt_dir, name), os.path.join(ckpt_dir, f".{name}.tmp")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": step}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, init_state):
    """The latest checkpoint under ``ckpt_dir`` as (model, optimizer, step);
    (fresh init, 0) where there is none."""
    model, optimizer = init_state()
    latest = None
    if os.path.isdir(ckpt_dir):
        cands = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
        latest = cands[-1] if cands else None
    if latest is None:
        return model, optimizer, 0
    state = torch.load(os.path.join(ckpt_dir, latest),
                       map_location=next(model.parameters()).device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return model, optimizer, int(state["step"])


def export_npz(model, path: str) -> str:
    """Write inference-format weights (the JAX package's ``.npz``) from a
    model or a MONAI-keyed state dict."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    save_params_npz(path, jax_params_from_state_dict(sd))
    return path


def train(
    cfg: TrainConfig,
    batches,
    n_steps: int,
    mesh: Mesh | None = None,
    params=None,
    log_every: int = 50,
    ckpt_dir: str | None = None,
    ckpt_every: int = 500,
    device=None,
):
    """Training loop over an (x, y) batch iterator; returns the model.
    ``params``: a MONAI-keyed state dict to start from. With ``ckpt_dir``
    (and no ``params``), resumes from the latest checkpoint, drawing steps
    ``start..n_steps`` from ``batches``, and saves every ``ckpt_every``
    steps and after the last."""
    init_state, step = make_train_step(cfg, mesh, device)
    start = 0
    if ckpt_dir is not None and params is None:
        model, optimizer, start = restore_checkpoint(ckpt_dir, init_state)
        if start:
            print(f"resumed from step {start}", flush=True)
    else:
        model, optimizer = init_state()
        if params is not None:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    for i, (x, y) in zip(range(start, n_steps), batches):
        loss = step(model, optimizer, x, y)
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            print(f"step {i}: loss {float(loss):.4f}", flush=True)
        if ckpt_dir is not None and ((i + 1) % ckpt_every == 0 or i == n_steps - 1):
            save_checkpoint(ckpt_dir, i + 1, model, optimizer)
    return model
