"""Gated and plain MLP blocks (the port of ``repro/models/mlp.py``).

Under a mesh whose rules split ``ffn`` (``models/sharding.py``), a rank
holds column blocks of ``up`` and ``gate`` and the matching row block of
``down`` (``launch/sharding.py``): its input goes through "identity
forward, all_reduce backward" and its partial output through "all_reduce
forward, identity backward"."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as msh
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


def _ffn_group(params: dict, cfg: ArchConfig):
    """The ``model`` line the hidden units are split over, or None (no
    mesh, or a width the axis does not divide: the leaves are whole)."""
    if msh.active() is None or params["up"].shape[-1] == cfg.d_ff:
        return None
    return msh.group_of(("model",))


def mlp(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP of width ``cfg.d_ff`` (every caller's, arctic's dense
    branch included)."""
    act = _ACT[cfg.act]
    group = _ffn_group(params, cfg)
    x = msh.reduce_grad(x, group)
    h = x @ params["up"]
    h = h * act(x @ params["gate"]) if "gate" in params else act(h)
    if h.dim() == 3:
        h = msh.shard(h, "batch", "seq", "ffn", whole=(None, None, cfg.d_ff))
    return msh.all_reduce(h @ params["down"], group)
