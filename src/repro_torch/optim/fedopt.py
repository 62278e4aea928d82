"""Server optimizers (Reddi et al. 2020 FedOpt family).

The paper's Algorithm 1 uses x^{t+1} = x^t - eta_g d^t (FedAvgServer with
eta_g = 1).  FedAdam is provided as a framework feature (disabled in the
paper-faithful experiment configs).  Both are pure: ``apply`` returns new
tensors and leaves its inputs untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.fed.tasks import tree_leaves, tree_map

__all__ = ["ServerOptimizer", "FedAvgServer", "FedAdam"]


@dataclasses.dataclass(frozen=True)
class ServerOptimizer:
    lr: float = 1.0

    def init(self, params) -> Any:
        return ()

    def apply(self, params, estimate, state):
        """estimate = d^t (weighted client *updates*, a descent direction)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FedAvgServer(ServerOptimizer):
    def apply(self, params, estimate, state):
        return tree_map(lambda p, d: p - self.lr * d.to(p.dtype), params, estimate), state


@dataclasses.dataclass(frozen=True)
class FedAdam(ServerOptimizer):
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-3

    def init(self, params):
        device = tree_leaves(params)[0].device
        return (
            tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params),
            torch.zeros((), dtype=torch.int32, device=device),
        )

    def apply(self, params, estimate, state):
        m, v, t = state
        t = t + 1
        m = tree_map(
            lambda m_, d: self.beta1 * m_ + (1 - self.beta1) * d.to(m_.dtype), m, estimate
        )
        v = tree_map(
            lambda v_, d: self.beta2 * v_ + (1 - self.beta2) * d.to(v_.dtype).square(),
            v,
            estimate,
        )
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(self.beta1, tf)
        bc2 = 1 - torch.pow(self.beta2, tf)
        new = tree_map(
            lambda p, m_, v_: p - self.lr * (m_ / bc1) / ((v_ / bc2).sqrt() + self.eps),
            params,
            m,
            v,
        )
        return new, (m, v, t)
