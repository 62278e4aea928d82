"""Client-side optimizers (the paper uses vanilla SGD with constant step)."""
from __future__ import annotations

import torch

from repro_torch.fed.tasks import tree_map

__all__ = ["sgd_step", "momentum_init", "momentum_step"]


def sgd_step(params, grads, lr):
    return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)


def momentum_init(params):
    return tree_map(torch.zeros_like, params)


def momentum_step(params, mom, grads, lr, beta=0.9):
    mom = tree_map(lambda m, g: beta * m + g.to(m.dtype), mom, grads)
    params = tree_map(lambda p, m: p - lr * m, params, mom)
    return params, mom
