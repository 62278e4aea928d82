"""Gated MLP blocks (the port of ``repro/models/mlp.py``; the reference's
ungated form serves only the audio family, which is not ported)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, uniform_init

__all__ = ["init_mlp", "mlp"]

# jax.nn.gelu defaults to the tanh approximation, so "gelu" is tanh-gelu here.
_ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_mlp(cfg: ArchConfig, gen: torch.Generator | None) -> dict:
    return {
        "up": uniform_init(gen, (cfg.d_model, cfg.d_ff), cfg.param_dtype),
        "down": uniform_init(gen, (cfg.d_ff, cfg.d_model), cfg.param_dtype),
        "gate": uniform_init(gen, (cfg.d_model, cfg.d_ff), cfg.param_dtype),
    }


def mlp(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = (x @ params["up"]) * _ACT[cfg.act](x @ params["gate"])
    return h @ params["down"]
