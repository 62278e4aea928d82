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

Under a mesh with ``model`` > 1 (``models/sharding.py``), a rank holds
E/M experts (``launch/sharding.py``; the router is gathered whole):

* the dense dispatch (``moe_impl="dense"``): every rank routes every token
  exactly as above (the same ``capacity`` over all tokens, the same slots),
  fills only its own experts' buffers and combines its own experts'
  outputs; one all_reduce sums the partial outputs.  The tokens and the
  combine weights enter through "identity forward, all_reduce backward";
* ``moe_impl="a2a"`` (``_moe_ffn_a2a``, the reference's body): each rank
  takes its block of the sequence, packs its (token, expert) rows by the
  owning rank (``_pack_by_dest``, ``cap_pair`` rows each), exchanges them
  by ``all_to_all`` over ``model``, runs its E/M experts (``cap_local``
  rows each), sends the results back and combines them; the output is
  all-gathered over the sequence and the aux loss averaged over ``model``
  (and the batch axes where they split the rows).

Where a batch's rows are split over several ranks (the rules' batch axes,
or a split ``cohort_sequential`` round's ``split_rows``:
``models.sharding.row_split``), the dense dispatch computes the whole
batch's function, as the reference's GSPMD program does: ``cap`` counts
every row's tokens; each pair's slot is its position among all the batch's
tokens in row order (one ``all_gather`` of the (E,) counts, the lower
ranks' summed before this rank's cumulative sum); ``frac`` and
``mean_gate`` are sums all-reduced over the rows' line (one ``all_reduce``
of a (2, E) tensor) over the whole token count.  A rank's loss enters the
step weighted by its share of the rows, so its part of the aux's gradient
is scaled by the inverse share: summed over the ranks, the aux's gradient
comes out once.  The a2a keeps the reference's per-shard capacity and
averaged aux.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as msh
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


def route(router: torch.Tensor, cfg: ArchConfig, xf: torch.Tensor, rows=None):
    """xf (T, d) -> (gates (T, E) f32, top_w (T, k) renormalised, top_idx
    (T, k), expert_mask (T, E) f32, slot (T, k) int, keep (T, k) bool).

    ``rows``: ``(line, whole tokens)`` when xf is this rank's block of a
    batch whose rows the line splits (contiguous, lower ranks first): the
    capacity is the whole batch's, and each pair's slot its position among
    all the batch's tokens."""
    e, k = cfg.n_experts, cfg.top_k
    gates = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    top_w, top_idx = torch.topk(gates, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(cfg, xf.shape[0] if rows is None else rows[1])
    # The top-k experts of a token are distinct, so the mask is 0/1.  A
    # comparison with arange, not F.one_hot (which checks its input's range
    # on the host, and vmap refuses that).
    experts = torch.arange(e, device=xf.device)
    expert_mask = (top_idx[..., None] == experts).to(torch.float32).sum(1)  # (T, E)
    position = torch.cumsum(expert_mask, dim=0) * expert_mask - 1.0  # exact below 2**24 tokens
    if rows is not None:  # after the lower ranks' pairs of each expert
        line = rows[0]
        counts = msh.all_gather(expert_mask.sum(0)[None], line, 0)  # (S, E), exact integers
        position = position + counts[: line.rank].sum(0) * expert_mask
    slot = torch.gather(position, 1, top_idx).to(torch.int32)
    keep = (slot >= 0) & (slot < cap)
    return gates, top_w, top_idx, expert_mask, slot, keep


def _expert_group(params: dict, cfg: ArchConfig):
    """The ``model`` line the experts are split over, or None."""
    if msh.active() is None or params["w_up"].shape[0] == cfg.n_experts:
        return None
    return msh.group_of(("model",))


def moe_ffn(params: dict, cfg: ArchConfig, x: torch.Tensor):
    """Returns (output (B, S, d) in x's dtype, aux load-balance loss f32)."""
    group = _expert_group(params, cfg)
    if group is not None and cfg.moe_impl == "a2a":
        return _moe_ffn_a2a(params, cfg, x, group)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(b * s, d)
    split = msh.row_split(b)  # (the rows' line, the whole batch's rows) or None
    rows = None if split is None else (split[0], split[1] * s)
    gates, top_w, top_idx, expert_mask, slot, keep = route(params["router"], cfg, xf, rows)
    n_tok = b * s if rows is None else rows[1]
    cap = capacity(cfg, n_tok)
    slot_c = torch.clamp(slot, 0, cap - 1).long()
    # This rank's experts [e0, e0 + e_loc) (all of them without a mesh).
    e_loc = params["w_up"].shape[0]
    e0 = 0 if group is None else group.rank * e_loc
    if group is not None:
        xf, top_w = msh.reduce_grad(xf, group), msh.reduce_grad(top_w, group)

    # Each of the k choices: the kept pairs this rank's experts serve and
    # their local expert ids.
    owned = []
    for kk in range(k):
        own, idx = keep[:, kk], top_idx[:, kk]
        if group is not None:
            idx = idx - e0
            own = own & (idx >= 0) & (idx < e_loc)
            idx = torch.where(own, idx, 0)
        owned.append((own, idx))

    # Scatter tokens into the (E, cap, d) expert buffers: k scatter-adds.
    ex_in = torch.zeros((e_loc, cap, d), dtype=x.dtype, device=x.device)
    for kk, (own, idx) in enumerate(owned):
        contrib = torch.where(own[:, None], xf, 0).to(x.dtype)
        ex_in = ex_in.index_put((idx, slot_c[:, kk]), contrib, accumulate=True)
    ex_in = msh.shard(ex_in, "experts", None, None, whole=(e, None, None))

    h = torch.bmm(ex_in, params["w_up"])
    g = torch.bmm(ex_in, params["w_gate"])
    h = h * F.silu(g)
    h = msh.shard(h, "experts", None, "ffn", whole=(e, None, None))
    ex_out = torch.bmm(h, params["w_down"])  # (E, cap, d)

    # Combine: k gathers weighted by the renormalised router weights.
    out = torch.zeros_like(xf)
    for kk, (own, idx) in enumerate(owned):
        piece = ex_out[idx, slot_c[:, kk]]  # (T, d)
        w = torch.where(own, top_w[:, kk], 0.0)[:, None].to(x.dtype)
        out = out + w * piece
    out = msh.all_reduce(out, group).reshape(b, s, d)

    if "dense" in params:
        out = out + mlp(params["dense"], cfg, x)

    if split is None:
        frac = expert_mask.mean(0)
        mean_gate = gates.mean(0)
    else:
        # The whole batch's sums; this rank's gradient scaled by whole / local
        # rows (module docstring).  x - x.detach() is an exact zero.
        sums = torch.stack([expert_mask.sum(0), gates.sum(0)])
        sums = msh.all_reduce(sums.detach(), split[0]) + (split[1] / b) * (sums - sums.detach())
        frac, mean_gate = sums[0] / n_tok, sums[1] / n_tok
    aux = e * torch.sum(frac * mean_gate)
    return out, aux


# ---------------------------------------------------------------------------
# all-to-all dispatch over ``model`` (the reference's ``_moe_ffn_a2a``)
# ---------------------------------------------------------------------------


def _pack_by_dest(xf, dest, n_dest: int, cap: int, valid=None):
    """Pack rows of xf (T, d) into (n_dest, cap, d) buffers by dest (T,).

    Returns (buffers, slot (T,), kept (T,)): the cumsum slotting; rows past
    ``cap`` are dropped; rows with ``valid`` False (padding from the wire)
    neither take slots nor contribute.  Every kept row has a cell of its
    own, so the adds give the same bits in any order."""
    onehot = (dest[:, None] == torch.arange(n_dest, device=xf.device)).to(torch.float32)
    if valid is not None:
        onehot = onehot * valid[:, None].to(torch.float32)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    slot = pos.amax(1).to(torch.int64)
    kept = (slot >= 0) & (slot < cap)
    slot_c = torch.clamp(slot, 0, cap - 1)
    buf = torch.zeros((n_dest, cap, xf.shape[1]), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((dest.long(), slot_c), torch.where(kept[:, None], xf, 0),
                        accumulate=True)
    return buf, slot_c, kept


def _a2a_caps(cfg: ArchConfig, t_local: int, n_model: int) -> tuple[int, int]:
    """(cap_pair, cap_local): the rows a (source, destination) pair ships
    and the rows of a local expert's buffer, the reference's rounding."""
    e_local = cfg.n_experts // n_model
    k = cfg.top_k
    cap_pair = int(max(8, round(cfg.capacity_factor * t_local * k / n_model)))
    cap_local = int(max(8, round(cfg.capacity_factor * t_local * k * 1.0 / e_local)))
    return cap_pair, cap_local


def _moe_ffn_a2a(params: dict, cfg: ArchConfig, x: torch.Tensor, group):
    """Expert-parallel MoE with explicit all-to-all dispatch over ``group``
    (the ``model`` line; module docstring).  x (B, S, d) is this rank's
    rows, whole over the sequence; S must be a multiple of the line."""
    n_model = group.size
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    e_local = e // n_model
    bsz, s, _ = x.shape
    if s % n_model:
        raise ValueError(f"moe_impl='a2a' splits the sequence ({s}) over model={n_model}")
    s_loc = s // n_model
    t = bsz * s_loc
    cap_pair, cap_local = _a2a_caps(cfg, t, n_model)
    # The residual stream is whole on every rank: this rank's slice of the
    # sequence, whose gradient the other ranks' slices complete.
    xb = msh.reduce_grad(x, group)[:, group.rank * s_loc:(group.rank + 1) * s_loc]
    xf = xb.reshape(t, d)
    router = msh.reduce_grad(params["router"], group)
    gates = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    top_w, top_idx = torch.topk(gates, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_idx = top_idx.reshape(t * k)
    flat_w = top_w.reshape(t * k)
    dest = torch.div(flat_idx, e_local, rounding_mode="floor")
    x_rep = torch.repeat_interleave(xf, k, dim=0)  # (t*k, d)
    send, slot, kept = _pack_by_dest(x_rep, dest, n_model, cap_pair)
    # expert-local ids ride along, +1 so that 0 marks wire padding
    meta = (flat_idx % e_local + 1).to(xf.dtype)[:, None]
    send_meta, _, _ = _pack_by_dest(meta, dest, n_model, cap_pair)
    recv = msh.all_to_all(send, group)
    recv_meta = msh.all_to_all(send_meta, group)

    rows = recv.reshape(n_model * cap_pair, d)
    meta_rows = recv_meta.reshape(n_model * cap_pair)
    wire_valid = meta_rows > 0.5
    eid = torch.clamp(meta_rows.to(torch.int64) - 1, 0, e_local - 1)
    ebuf, eslot, ekept = _pack_by_dest(rows, eid, e_local, cap_local, valid=wire_valid)
    ebuf = msh.shard(ebuf, "experts", None, None, whole=(e, None, None))
    h = torch.bmm(ebuf, params["w_up"])
    g = torch.bmm(ebuf, params["w_gate"])
    h = h * F.silu(g)
    eout = torch.bmm(h, params["w_down"])  # (E_loc, cap_local, d)
    back_rows = torch.where(ekept[:, None], eout[eid, eslot], 0)
    ret = msh.all_to_all(back_rows.reshape(n_model, cap_pair, d), group)

    got = torch.where(kept[:, None], ret[dest, slot], 0)  # (t*k, d)
    out = (got * flat_w[:, None].to(got.dtype)).reshape(t, k, d).sum(1)
    experts = torch.arange(e, device=x.device)
    frac = (top_idx[..., None] == experts).to(torch.float32).sum(1).mean(0)
    aux = e * torch.sum(frac * gates.mean(0))
    aux = msh.all_reduce(aux, group) / n_model
    rows_group = msh.batch_group()
    if rows_group is not None:
        aux = msh.all_reduce(aux, rows_group) / rows_group.size
    out = msh.all_gather(out.reshape(bsz, s_loc, d), group, 1)
    if "dense" in params:
        out = out + mlp(params["dense"], cfg, x)
    return out, aux
