"""Segmentation losses for BasicUNet training.

The port's counterpart of ``delivr_cfos_tpu/training/losses.py``: soft Dice
over the whole batch plus sigmoid BCE, in float32, with the JAX package's
formulas. The reference ships training patches but no training code
(SURVEY.md §2.4).

Gradients at a logit of exactly 0 follow JAX's rules: ``jnp.maximum(z, 0)``
gives half the gradient to each side (``torch.maximum`` does the same, where
``clamp_min`` and ``relu`` do not), and ``jnp.abs`` differentiates as +1 at 0
(``torch.abs`` as 0), so |z| is written as a select.
"""

from __future__ import annotations

import torch


def _abs(z: torch.Tensor) -> torch.Tensor:
    """|z| with JAX's gradient at 0 (+1)."""
    return torch.where(z >= 0, z, -z)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Soft Dice over the whole batch (one ratio, not a per-sample mean);
    logits (N, D, H, W, 1), targets the same shape."""
    probs = torch.sigmoid(logits.float())
    t = targets.float()
    num = 2.0 * torch.sum(probs * t) + eps
    den = torch.sum(probs) + torch.sum(t) + eps
    return 1.0 - num / den


def bce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-voxel sigmoid BCE, max(z, 0) − z·t + log1p(exp(−|z|))."""
    z = logits.float()
    t = targets.float()
    return torch.maximum(z, torch.zeros_like(z)) - z * t + torch.log1p(torch.exp(-_abs(z)))


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE, mean over voxels."""
    return torch.mean(bce_terms(logits, targets))


def dice_bce_loss(logits, targets, dice_weight: float = 1.0, bce_weight: float = 1.0):
    return dice_weight * dice_loss(logits, targets) + bce_weight * bce_loss(logits, targets)


def loss_sums(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The four sums ``dice_bce_loss`` is made of, (Σp·t, Σp, Σt, Σbce), for
    a caller that holds the batch in pieces (``parallel/sharded_training.py``)
    and adds the pieces' sums before taking the ratio."""
    probs = torch.sigmoid(logits.float())
    t = targets.float()
    return torch.stack([torch.sum(probs * t), torch.sum(probs), torch.sum(t),
                        torch.sum(bce_terms(logits, targets))])


def dice_bce_from_sums(sums: torch.Tensor, n_voxels: int, dice_weight: float = 1.0,
                       bce_weight: float = 1.0, eps: float = 1e-5) -> torch.Tensor:
    """``dice_bce_loss`` from the whole batch's ``loss_sums`` over
    ``n_voxels`` voxels."""
    s_pt, s_p, s_t, s_bce = sums.unbind()
    dice = 1.0 - (2.0 * s_pt + eps) / (s_p + s_t + eps)
    return dice_weight * dice + bce_weight * (s_bce / n_voxels)
