"""Gated and plain MLP blocks (the port of ``repro/models/mlp.py``)."""
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


def init_mlp(cfg: ArchConfig, gen: torch.Generator | None, d_ff: int | None = None,
             gated: bool = True) -> dict:
    """``up`` (d, d_ff), ``down`` (d_ff, d) and, when ``gated``, ``gate``
    (d, d_ff); ``d_ff`` defaults to ``cfg.d_ff`` (arctic's dense residual
    branch passes its own)."""
    d_ff = d_ff or cfg.d_ff
    p = {
        "up": uniform_init(gen, (cfg.d_model, d_ff), cfg.param_dtype),
        "down": uniform_init(gen, (d_ff, cfg.d_model), cfg.param_dtype),
    }
    if gated:
        p["gate"] = uniform_init(gen, (cfg.d_model, d_ff), cfg.param_dtype)
    return p


def mlp(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    act = _ACT[cfg.act]
    h = x @ params["up"]
    h = h * act(x @ params["gate"]) if "gate" in params else act(h)
    return h @ params["down"]
