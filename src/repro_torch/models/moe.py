"""Mixture-of-Experts FFN: top-k router with capacity-based dense dispatch
(the port of ``repro/models/moe.py``, same names).

Each token's router softmax (f32) picks its top-k experts; the k weights are
renormalised to sum to 1.  One (T, E) cumulative sum over the routing mask
gives every (token, expert) pair its slot in that expert's buffer of
``cap = max(1, round(capacity_factor * T * k / E))`` rows (Python's
``round``: half to even, as the reference rounds); pairs past ``cap`` are
dropped.  k scatter-adds fill the (E, cap, d) buffers, three batched
products (``torch.bmm``: GEMMs, outside any Pallas kernel in the reference
too) run the experts, and k weighted gathers combine the results.  Arctic
adds its always-on dense MLP.  The auxiliary load-balance loss is the
Switch Transformer's ``E * sum_e frac_e * mean_gate_e`` over the routing
mask before the capacity drop.

Determinism: a dropped pair adds an exact zero row at slot ``cap - 1`` of
its expert, where a kept row may sit; every cell holds at most one kept
row, so the adds (and the backward of the gathers, whose dropped rows carry
weight 0) give the same bits in any order.  Every op is out of place and
``cap`` is a Python int from static shapes, so ``torch.func.vmap`` batches
the function over clients.

``moe_impl="a2a"`` is the reference's expert-parallel all-to-all under a
mesh with a ``model`` axis; without a mesh the reference takes the dense
path, and the port has no mesh (``api.run`` refuses a mesh shape other than
None or all ones; ROADMAP.md section 1, item 6, 'Multi-rank placement'), so
it always takes the dense path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, uniform_init
from repro_torch.models.mlp import init_mlp, mlp

__all__ = ["init_moe", "moe_ffn", "capacity", "route"]


def init_moe(cfg: ArchConfig, gen: torch.Generator | None) -> dict:
    """router (d, E) f32; w_gate, w_up (E, d, f) and w_down (E, f, d) in the
    parameter dtype (``uniform_init``'s fan-in is the leading axis, E, as in
    the reference); ``dense`` (a gated MLP of width d_ff) for arctic."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": uniform_init(gen, (d, e), torch.float32),
        "w_gate": uniform_init(gen, (e, d, f), cfg.param_dtype),
        "w_up": uniform_init(gen, (e, d, f), cfg.param_dtype),
        "w_down": uniform_init(gen, (e, f, d), cfg.param_dtype),
    }
    if cfg.dense_residual:
        p["dense"] = init_mlp(cfg, gen, d_ff=cfg.d_ff, gated=True)
    return p


def capacity(cfg: ArchConfig, n_tok: int) -> int:
    """Rows per expert buffer for ``n_tok`` tokens."""
    return int(max(1, round(cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts)))


def route(router: torch.Tensor, cfg: ArchConfig, xf: torch.Tensor):
    """xf (T, d) -> (gates (T, E) f32, top_w (T, k) renormalised, top_idx
    (T, k), expert_mask (T, E) f32, slot (T, k) int, keep (T, k) bool)."""
    e, k = cfg.n_experts, cfg.top_k
    gates = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    top_w, top_idx = torch.topk(gates, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(cfg, xf.shape[0])
    # The top-k experts of a token are distinct, so the mask is 0/1.  A
    # comparison with arange, not F.one_hot (which checks its input's range
    # on the host, and vmap refuses that).
    experts = torch.arange(e, device=xf.device)
    expert_mask = (top_idx[..., None] == experts).to(torch.float32).sum(1)  # (T, E)
    position = torch.cumsum(expert_mask, dim=0) * expert_mask - 1.0  # exact below 2**24 tokens
    slot = torch.gather(position, 1, top_idx).to(torch.int32)
    keep = (slot >= 0) & (slot < cap)
    return gates, top_w, top_idx, expert_mask, slot, keep


def moe_ffn(params: dict, cfg: ArchConfig, x: torch.Tensor):
    """Returns (output (B, S, d) in x's dtype, aux load-balance loss f32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(b * s, d)
    gates, top_w, top_idx, expert_mask, slot, keep = route(params["router"], cfg, xf)
    cap = capacity(cfg, b * s)
    slot_c = torch.clamp(slot, 0, cap - 1).long()

    # Scatter tokens into the (E, cap, d) expert buffers: k scatter-adds.
    ex_in = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        contrib = torch.where(keep[:, kk : kk + 1], xf, 0).to(x.dtype)
        ex_in = ex_in.index_put((top_idx[:, kk], slot_c[:, kk]), contrib, accumulate=True)

    h = torch.bmm(ex_in, params["w_up"])
    g = torch.bmm(ex_in, params["w_gate"])
    h = h * F.silu(g)
    ex_out = torch.bmm(h, params["w_down"])  # (E, cap, d)

    # Combine: k gathers weighted by the renormalised router weights.
    out = torch.zeros_like(xf)
    for kk in range(k):
        piece = ex_out[top_idx[:, kk], slot_c[:, kk]]  # (T, d)
        w = torch.where(keep[:, kk], top_w[:, kk], 0.0)[:, None].to(x.dtype)
        out = out + w * piece
    out = out.reshape(b, s, d)

    if "dense" in params:
        out = out + mlp(params["dense"], cfg, x)

    frac = expert_mask.mean(0)
    mean_gate = gates.mean(0)
    aux = e * torch.sum(frac * mean_gate)
    return out, aux
