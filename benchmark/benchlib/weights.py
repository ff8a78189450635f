"""Random weights of the configuration's model from the seed, made on the
device in one draw, under the state-dict keys that both the program and the
reference load. The model module that the configuration names gives the
keys, shapes and ranges (``state_shapes``)."""

from __future__ import annotations

import math

import torch

from benchlib import cells
from benchlib.phantom import generator


def make_weights(config: dict, seed: int, device) -> dict:
    """A float32 state dict on ``device`` from ``seed``: one uniform draw,
    cut into the tensors and scaled."""
    rows = cells.model_module(config).state_shapes(config)
    sizes = [math.prod(shape) for _, shape, _, _ in rows]
    u = torch.rand(sum(sizes), generator=generator(seed, device), device=device)
    u = u.mul_(2).sub_(1)
    sd = {}
    for (key, shape, bound, centre), part in zip(rows, torch.split(u, sizes)):
        sd[key] = (part * bound + centre).view(shape)
    return sd
