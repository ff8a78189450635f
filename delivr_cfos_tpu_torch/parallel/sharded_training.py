"""The BasicUNet train step over a ('dp', 'sp') device mesh: the batch split
over 'dp', z over 'sp'.

The port's counterpart of ``make_train_step(cfg, mesh)`` in
``delivr_cfos_tpu/training/train.py``, where ``jax.jit`` with shardings
leaves the halos and the reductions to XLA's partitioner. The port keeps the
single-controller design of ``parallel/sharded_inference.py``: one process
drives every shard of a ``parallel.mesh.Mesh``, one replica of the model
lives on each distinct device, and one autograd graph spans the shards, so
that the step computes the unsharded step's function. The forward is the
model's own ``BasicUNet.body`` with ``RowOps`` in place of its per-device
steps:

- each 3×3×3 conv of a shard concatenates one halo plane from each z
  neighbour, pulled with ``.to()`` so that the gradient flows back across
  devices, and zero planes at the global z ends (the SAME padding);
- InstanceNorm's statistics are global per (sample, channel): the shards'
  partial sums meet on the row's first device, which combines them and
  sends them back; a global mean first, then a global Σ(x − mean)², as
  ``jnp.var`` takes it;
- Dice and BCE take their sums over every shard in the same way;
- after the backward, the replicas' gradients are summed onto the model's
  own, the optimizer steps there, and the replicas take the model's
  parameters again before the next step.

Max-pooling and the stride-2 deconvs stay inside a shard, since a shard's
depth is a multiple of 16 (four pooling levels): a z that is not a multiple
of 16·sp raises. A mesh that names one device several times (the CPU
tests' ``["cpu"] * 8``, the one-card machine's ``["cuda:0"] * 4``) holds
one replica there and runs every shard's work on it.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.nn.functional as F

from delivr_cfos_tpu_torch.models.basic_unet import BasicUNet, mish
from delivr_cfos_tpu_torch.ops.instance_norm_mish import IN_EPS
from delivr_cfos_tpu_torch.parallel.mesh import Mesh
from delivr_cfos_tpu_torch.parallel.sharded_inference import _canonical, replicate
from delivr_cfos_tpu_torch.training.losses import dice_bce_from_sums, loss_sums
from delivr_cfos_tpu_torch.utils.device import full_f32


def mesh_grid(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as an (n_dp, n_sp) array; a missing axis has size
    1."""
    if set(mesh.axis_names) - {"dp", "sp"}:
        raise ValueError(f"a train mesh has axes 'dp' and 'sp', got {mesh.axis_names}")
    order = [mesh.axis_names.index(a) for a in ("dp", "sp") if a in mesh.axis_names]
    shape = mesh.shape
    return mesh.devices.transpose(order).reshape(shape.get("dp", 1), shape.get("sp", 1))


def split_batch(a, grid: np.ndarray) -> list:
    """(N, D, H, W, C) → rows over 'dp' of shards over 'sp', each (N/dp, C,
    D/sp, H, W) float32 on its device."""
    t = torch.as_tensor(a).float()
    n_dp, n_sp = grid.shape
    if t.shape[0] % n_dp:
        raise ValueError(f"batch {t.shape[0]} does not split over dp={n_dp}")
    if n_sp > 1 and t.shape[1] % (16 * n_sp):
        raise ValueError(f"z = {t.shape[1]} is not a multiple of 16·sp = {16 * n_sp}: "
                         "each shard must keep four pooling levels")
    nb, dz = t.shape[0] // n_dp, t.shape[1] // n_sp
    return [[t[r * nb:(r + 1) * nb, k * dz:(k + 1) * dz].permute(0, 4, 1, 2, 3)
             .contiguous().to(grid[r, k]) for k in range(n_sp)] for r in range(n_dp)]


class RowOps:
    """``models/basic_unet.py::LocalOps`` for a row of z-shards: every
    activation is a list, one tensor a shard, and shard k runs on
    ``mods[k]``, its device's replica. Only the 3×3×3 conv (halo planes)
    and the norm+mish (global statistics) differ from the per-device steps;
    ``each`` maps a step over the shards, each on its replica's twin of the
    module it names."""

    def __init__(self, mods):
        self.mods = mods
        self.twins = {m: [r.get_submodule(n) for r in mods]
                      for n, m in mods[0].named_modules()}

    def each(self, fn, *args):
        """``fn`` on each shard: a list argument gives its k-th tensor, a
        module its twin on shard k's replica."""
        return [fn(*(a[k] if isinstance(a, list) else self.twins[a][k] for a in args))
                for k in range(len(self.mods))]

    def conv(self, row, conv):
        """A 3×3×3 SAME conv of the row: one plane from each neighbour,
        pulled with ``.to()`` so that the gradient flows back, zeros at the
        global ends."""
        out = []
        for k, (x, c) in enumerate(zip(row, self.twins[conv])):
            edge = torch.zeros_like(x[:, :, :1])
            lo = row[k - 1][:, :, -1:].to(x.device) if k > 0 else edge
            hi = row[k + 1][:, :, :1].to(x.device) if k + 1 < len(row) else edge
            y = F.conv3d(torch.cat([lo, x, hi], 2), c.weight, padding=(0, 1, 1))
            out.append(y + c.bias[None, :, None, None, None])
        return out

    def norm_mish(self, row, adn):
        """InstanceNorm over the row's whole depth, then mish, per shard."""
        home = row[0].device
        n_vox = sum(x[0, 0].numel() for x in row)
        mean = sum(x.sum(dim=(2, 3, 4)).to(home) for x in row) / n_vox
        means = [mean.to(x.device)[:, :, None, None, None] for x in row]
        var = sum(((x - m) ** 2).sum(dim=(2, 3, 4)).to(home)
                  for x, m in zip(row, means)) / n_vox
        inv = torch.rsqrt(var + IN_EPS)
        out = []
        for x, m, a in zip(row, means, self.twins[adn]):
            y = (x - m) * inv.to(x.device)[:, :, None, None, None]
            out.append(mish(y * a.N.weight[None, :, None, None, None]
                            + a.N.bias[None, :, None, None, None]))
        return out


def sharded_forward(row, mods) -> list:
    """The parity BasicUNet forward of one 'dp' row of z-shards (NCDHW, f32)
    on ``mods``, each shard's replica; returns each shard's logits."""
    return mods[0].body(row, RowOps(mods))


def sharded_loss(model: BasicUNet, replicas: dict, grid: np.ndarray, x, y) -> torch.Tensor:
    """Dice+BCE of the whole batch, on the model's device."""
    home = next(model.parameters()).device
    mods = [[replicas[_canonical(d)] for d in row] for row in grid]
    xs, ys = split_batch(x, grid), split_batch(y, grid)
    sums = 0
    for row_x, row_y, row_m in zip(xs, ys, mods):
        logits = sharded_forward(row_x, row_m)
        sums = sums + sum(loss_sums(z, t).to(home) for z, t in zip(logits, row_y))
    n_voxels = sum(t.numel() for row in ys for t in row)
    return dice_bce_from_sums(sums, n_voxels)


def make_sharded_step(mesh: Mesh):
    """``step(model, optimizer, x, y)`` over ``mesh``: one Adam step of the
    model (on the mesh's first device) on the batch (N, D, H, W, 1) split
    (dp, sp), forward and backward in full float32; returns the loss."""
    grid = mesh_grid(mesh)
    cache = weakref.WeakKeyDictionary()  # model → {device: replica}

    def replicas_of(model):
        reps = cache.get(model)
        if reps is None:
            reps = cache[model] = replicate(model, list(grid.flat))
        with torch.no_grad():
            for rep in reps.values():
                if rep is not model:
                    for p, q in zip(model.parameters(), rep.parameters()):
                        q.copy_(p)
                        q.grad = None
        return reps

    def step(model, optimizer, x, y):
        reps = replicas_of(model)
        optimizer.zero_grad(set_to_none=True)
        with full_f32():
            loss = sharded_loss(model, reps, grid, x, y)
            loss.backward()
        for rep in reps.values():
            if rep is not model:
                for p, q in zip(model.parameters(), rep.parameters()):
                    if q.grad is not None:
                        g = q.grad.to(p.device)
                        p.grad = g if p.grad is None else p.grad + g
        optimizer.step()
        return loss.detach()

    return step
