"""xLSTM blocks (Beck et al. 2024, arXiv:2405.04517): sLSTM and mLSTM (the
port of ``repro/models/xlstm.py``, same names).

mLSTM: a matrix-memory cell C (hd x hd) with an exponential input gate and a
stabiliser state m, a gated linear-attention recurrence, here a Python loop
over time (the reference scans it); ``mlstm_chunked`` is the chunkwise form
of the same function, picked by ``cfg.mlstm_impl == "chunked"``.

sLSTM: a scalar-memory cell with a block-diagonal hidden-to-gate recurrence
per head, inherently sequential.  ``cfg.slstm_segment > 0`` recomputes the
loop a segment at a time in the backward (``models.remat.recompute``, under
``backward()`` and ``torch.func`` alike): the same values, less memory for
the backward.

Both blocks carry their own projections (the config's d_ff = 0): the mLSTM
block up-projects by 2x with a gated output; the sLSTM block is followed by
a 4/3-width gated FFN.  Each block's inner norm (``norm_scale``) goes
through kernel 6 (``models.common.rms_norm``).

The stabilisers start where the reference starts them: the mLSTM training
cell at -inf, the decode states and ``mlstm_chunked`` at -1e30.  The decode
steps write the new states into the state dict they are given, in place
(the serving engine's caches keep their addresses), and return that dict.

A prefill (``mlstm_prefill``) runs the projections and the inner norm
once over the prompt and the decode cell a token at a time from the decode
states' start, the reference's function (its prefill folds the prompt in
with the decode step).

Under ``models.sharding.use_rules`` an mLSTM block may hold this rank's
blocks of its projections over the ``model`` line (``line``, chosen by
``models/transformer.py:_split_cells``; the reference's ``"state"`` rule,
``shard(q, "batch", "seq", "state", None)``): columns of ``up``, ``wq``,
``wk``, ``wv`` and ``w_if``, channels of ``conv_w``, rows of ``down``.  No
weight is gathered: ``up``'s and the conv's outputs and the gates are
all-gathered, ``wq``/``wk``/``wv``'s column blocks are this rank's heads,
the heads' outputs are gathered for the inner norm (kernel 6 over the
whole row), and ``down``'s row block gives a partial product, summed in
f32 (``sharding.row_block_matmul``).  Training and prefill run the cell on
this rank's heads, a prefill moving the final states to the cache's
layout by all_to_all; a decode step gathers every head's q, k, v and gates
and updates the state blocks in the layout its cache has (``layout``),
``h`` from the blocks' partial sums all-reduced (or gathered).  With
``line`` None (no mesh, or a line that does not divide the heads, whose
leaves ``models/transformer.py`` gathers whole) the code is the unsplit
one.  The sLSTM has no ``state``
annotation in the reference: its block is always gathered whole at use,
and a decode step gathers its split state and keeps its blocks
(``models/transformer.py:_keep_blocks``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import remat
from repro_torch.models import sharding as msh
from repro_torch.models.common import ArchConfig, rms_norm, uniform_init
from repro_torch.models.ssm import _causal_conv

__all__ = [
    "mlstm_chunked",
    "init_mlstm",
    "mlstm_block",
    "mlstm_prefill",
    "init_mlstm_state",
    "mlstm_decode_step",
    "init_slstm",
    "slstm_block",
    "init_slstm_state",
    "slstm_decode_step",
]


def _zeros(shape, dtype, gen):
    return torch.zeros(shape, dtype=dtype, device="meta" if gen is None else gen.device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ArchConfig, gen: torch.Generator | None) -> dict:
    d = cfg.d_model
    d_in = 2 * d  # projection factor 2
    dt = cfg.param_dtype
    return {
        "up": uniform_init(gen, (d, 2 * d_in), dt),  # -> [x, z]
        "conv_w": uniform_init(gen, (cfg.conv_width, d_in), dt, scale=0.5),
        "wq": uniform_init(gen, (d_in, d_in), dt),
        "wk": uniform_init(gen, (d_in, d_in), dt),
        "wv": uniform_init(gen, (d_in, d_in), dt),
        "w_if": uniform_init(gen, (d_in, 2 * cfg.n_heads), dt),
        "if_bias": _zeros((2 * cfg.n_heads,), torch.float32, gen),
        "norm_scale": _zeros((d_in,), dt, gen),
        "down": uniform_init(gen, (d_in, d), dt),
    }


def _mlstm_step(c, n, m, q_t, k_t, v_t, lf, li, line=None, layout=None):
    """One stabilised mLSTM step: c (B,H,hd,hd), n (B,H,hd), m (B,H); q_t,
    k_t, v_t (B,H,hd) f32, q and k pre-scaled; lf, li (B,H) log forget and
    input gates.  Returns (c, n, m, h_t (B,H,hd)).

    Under ``line`` c, n and m are this rank's blocks along ``layout``'s
    dimension of each (c: 1 heads, 2 v, 3 k; n: 1 heads, 2 k; m: 1 heads;
    None whole) and the inputs every head's: the new blocks, and h_t whole
    (the m block's gate factors gathered; c·q and n·q over a k block are
    partial sums, all-reduced together, over a head or v block gathered)."""
    at = {} if line is None else layout

    def on(t, leaf, dims):  # t's slice of ``leaf``'s block: dims maps its split dim to t's
        return t if at.get(leaf) not in dims else msh.block(t, line, dims[at[leaf]])

    lf_m, li_m = on(lf, "m", {1: 1}), on(li, "m", {1: 1})
    m_new = torch.maximum(lf_m + m, li_m)
    f_s = torch.exp(lf_m + m - m_new)[..., None]  # (B,H,1)
    i_s = torch.exp(li_m - m_new)[..., None]
    floor = torch.exp(-m_new)[..., None]
    if at.get("m") == 1:
        f_s, i_s, floor = msh.all_gather(torch.cat([f_s, i_s, floor], -1), line, 1).split(1, -1)
    # (i v) k^T, not i (v k^T): the backward then keeps no (hd, hd) outer
    # product a step, only C itself (the next step's input); training at
    # xlstm-125m's width holds 64 steps x 6 blocks of these.
    c = (c * on(f_s, "c", {1: 1})[..., None]
         + (on(i_s, "c", {1: 1}) * on(v_t, "c", {1: 1, 2: 2}))[..., :, None]
         * on(k_t, "c", {1: 1, 3: 2})[..., None, :])
    n = n * on(f_s, "n", {1: 1}) + on(i_s, "n", {1: 1}) * on(k_t, "n", {1: 1, 2: 2})
    nq = torch.sum(n * on(q_t, "n", {1: 1, 2: 2}), dim=-1, keepdim=True)
    num = torch.einsum("bhvk,bhk->bhv", c, on(q_t, "c", {1: 1, 3: 2}))
    if at.get("c") == 3 and at.get("n") == 2:  # both partial sums: one all_reduce
        num, nq = msh.all_reduce(torch.cat([num, nq], -1), line).split([num.shape[-1], 1], -1)
    else:
        num = (msh.all_reduce(num, line) if at.get("c") == 3
               else msh.redistribute(num, line, at.get("c"), None))
        nq = msh.all_reduce(nq, line) if at.get("n") == 2 else msh.redistribute(nq, line, at.get("n"), None)
    denom = torch.maximum(torch.abs(nq), floor)
    return c, n, m_new, num / denom


def _mlstm_cell(q, k, v, i_gate, f_gate, m0: float = -math.inf, return_state: bool = False):
    """Stabilised mLSTM recurrence.  q, k, v (B,S,H,hd); gates (B,S,H)
    pre-activation.  Returns h (B,S,H,hd) f32, and with ``return_state``
    the final (c, n, m); the stabiliser starts at ``m0``."""
    bsz, s, h, hd = q.shape
    logf = F.logsigmoid(f_gate.to(torch.float32))
    logi = i_gate.to(torch.float32)
    scale = hd**-0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32) * scale
    vf = v.to(torch.float32)
    dev = q.device
    c = torch.zeros((bsz, h, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((bsz, h, hd), dtype=torch.float32, device=dev)
    m = torch.full((bsz, h), m0, dtype=torch.float32, device=dev)
    hs = []
    for t in range(s):
        c, n, m, h_t = _mlstm_step(c, n, m, qf[:, t], kf[:, t], vf[:, t], logf[:, t], logi[:, t])
        hs.append(h_t)
    out = torch.stack(hs, dim=1)
    return (out, (c, n, m)) if return_state else out


def _mlstm_qkv_gates(params: dict, cfg: ArchConfig, x: torch.Tensor, conv_state=None, line=None,
                     every_head: bool = False):
    """The block's projections: (z, q, k, v (B,S,H,hd) in x's dtype, i and f
    gate pre-activations (B,S,H) f32, the new conv state).  Under ``line``
    (the module docstring): z whole, q, k, v and the gates of this rank's heads, or
    with ``every_head`` of every head; the conv state is this rank's
    channel block."""
    bsz, s, d = x.shape
    d_in = 2 * d
    hd = d_in // cfg.n_heads
    x = msh.reduce_grad(x, line)
    (up,) = msh.gather_blocks([x @ params["up"]], line)
    xi, z = up[..., :d_in], up[..., d_in:]
    xc, conv_state = _causal_conv(msh.block(xi, line), params["conv_w"], conv_state)
    (xc,) = msh.gather_blocks([F.silu(xc)], line)
    q, k, v, g = xc @ params["wq"], xc @ params["wk"], xi @ params["wv"], xi @ params["w_if"]
    own = None if every_head else line  # the line of the heads this rank keeps
    if own is None:
        q, k, v, g = msh.gather_blocks([q, k, v, g], line)
    else:
        (g,) = msh.gather_blocks([g], line)
    q, k, v = (t.reshape(bsz, s, t.shape[-1] // hd, hd) for t in (q, k, v))
    bias = msh.reduce_grad(params["if_bias"], line)
    gates = (g + bias[None, None]).reshape(bsz, s, 2, cfg.n_heads)
    return (z, q, k, v, msh.block(gates[:, :, 0], own), msh.block(gates[:, :, 1], own),
            conv_state)


def _mlstm_out(params: dict, cfg: ArchConfig, h, z, line=None):
    """Inner norm (kernel 6, over the whole row of h (B,S,d_in), x's
    dtype), output gate, down projection; under ``line`` this rank's block
    of the gated row against its rows of ``down``
    (``sharding.row_block_matmul``)."""
    h = rms_norm(h, msh.reduce_grad(params["norm_scale"], line), cfg.norm_eps) * F.silu(z)
    return msh.row_block_matmul(msh.block(h, line), params["down"], line)


def mlstm_block(params: dict, cfg: ArchConfig, x: torch.Tensor, line=None) -> torch.Tensor:
    """x (B,S,d) -> y (B,S,d); on this rank's heads under ``line`` (the
    module docstring)."""
    bsz, s, d = x.shape
    z, q, k, v, i_gate, f_gate, _ = _mlstm_qkv_gates(params, cfg, x, line=line)
    q = msh.shard(q, "batch", "seq", "state", None,
                  whole=(None, None, cfg.n_heads, None) if line is not None else None)
    if cfg.mlstm_impl == "chunked":
        h, _ = mlstm_chunked(q, k, v, i_gate, f_gate, chunk=cfg.mlstm_chunk)
    else:
        h = _mlstm_cell(q, k, v, i_gate, f_gate)
    (h,) = msh.gather_blocks([h.reshape(bsz, s, -1).to(x.dtype)], line)
    return _mlstm_out(params, cfg, h, z, line)


def mlstm_prefill(params: dict, cfg: ArchConfig, x: torch.Tensor, line=None, layout=None):
    """A prompt x (B,S,d) folded into the decode states from their start
    (``init_mlstm_state``): the projections once, the decode cell a token
    at a time, the inner norm once over the sequence; returns (y (B,S,d),
    the final states).  Under ``line`` (the module docstring) the cell runs
    on this rank's heads and the states come laid out as the cache holds
    them (``layout``'s dimension of each), the conv's its channel block."""
    bsz, s, d = x.shape
    z, q, k, v, i_gate, f_gate, conv = _mlstm_qkv_gates(params, cfg, x, line=line)
    q = msh.shard(q, "batch", "seq", "state", None,
                  whole=(None, None, cfg.n_heads, None) if line is not None else None)
    h, (c, n, m) = _mlstm_cell(q, k, v, i_gate, f_gate, m0=-1e30, return_state=True)
    (h,) = msh.gather_blocks([h.reshape(bsz, s, -1).to(x.dtype)], line)
    state = {"c": c, "n": n, "m": m}
    if line is not None:
        state = {k: msh.redistribute(t, line, 1, layout[k]) for k, t in state.items()}
    state["conv"] = conv.to(torch.float32)  # the decode state's dtype
    return _mlstm_out(params, cfg, h, z, line), state


def init_mlstm_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    d_in = 2 * cfg.d_model
    hd = d_in // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, cfg.n_heads, hd, hd), **f32),
        "n": torch.zeros((batch, cfg.n_heads, hd), **f32),
        "m": torch.full((batch, cfg.n_heads), -1e30, **f32),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in), **f32),
    }


def mlstm_decode_step(params: dict, cfg: ArchConfig, x: torch.Tensor, state: dict, line=None,
                      layout=None):
    """x (B,1,d) -> (y (B,1,d), state), the state updated in place.  On this
    rank's blocks (the module docstring) ``state`` holds the blocks along
    ``layout``'s dimension of each leaf (``_mlstm_step``), the conv's
    channel block."""
    bsz = x.shape[0]
    d_in = 2 * cfg.d_model
    hd = d_in // cfg.n_heads
    z, q, k, v, i_gate, f_gate, conv_state = _mlstm_qkv_gates(params, cfg, x, state["conv"], line,
                                                              every_head=True)
    scale = hd**-0.5
    q = q[:, 0].to(torch.float32) * scale
    k = k[:, 0].to(torch.float32) * scale
    v = v[:, 0].to(torch.float32)
    logi = i_gate[:, 0].to(torch.float32)
    logf = F.logsigmoid(f_gate[:, 0].to(torch.float32))
    c, n, m, h = _mlstm_step(state["c"], state["n"], state["m"], q, k, v, logf, logi, line, layout)
    y = _mlstm_out(params, cfg, h.reshape(bsz, 1, d_in).to(x.dtype), z, line)
    for name, new in (("c", c), ("n", n), ("m", m), ("conv", conv_state)):
        state[name].copy_(new)
    return y, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg: ArchConfig, gen: torch.Generator | None) -> dict:
    d = cfg.d_model
    hd = d // cfg.n_heads
    d_ff = int(d * 4 / 3)
    dt = cfg.param_dtype
    return {
        "w_in": uniform_init(gen, (d, 4 * d), dt),  # i, f, z, o pre-activations
        "r": uniform_init(gen, (cfg.n_heads, hd, 4 * hd), dt),
        "bias": _zeros((4 * d,), torch.float32, gen),
        "norm_scale": _zeros((d,), dt, gen),
        "ffn_gate": uniform_init(gen, (d, d_ff), dt),
        "ffn_up": uniform_init(gen, (d, d_ff), dt),
        "ffn_down": uniform_init(gen, (d_ff, d), dt),
    }


def _slstm_gates(pre, h_prev, params, n_heads, hd):
    """pre (B,4d) input pre-activations; the recurrent contribution from
    h_prev (B,d) through the per-head blocks of ``r``."""
    bsz = pre.shape[0]
    rec = torch.einsum(
        "bhk,hkg->bhg", h_prev.reshape(bsz, n_heads, hd), params["r"].to(torch.float32)
    ).reshape(bsz, 4 * n_heads * hd)
    return pre + rec


def _slstm_step(params, n_heads, hd, c, n, m, h_prev, pre_t):
    """One sLSTM step on (B,d) f32 states; pre_t (B,4d) f32."""
    g = _slstm_gates(pre_t, h_prev, params, n_heads, hd)
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + m, gi)
    i_s = torch.exp(gi - m_new)
    f_s = torch.exp(logf + m - m_new)
    c = f_s * c + i_s * torch.tanh(gz)
    n = f_s * n + i_s
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return c, n, m_new, h


def _slstm_cell(params, x_pre, n_heads, hd, segment: int = 0):
    """x_pre (B,S,4d).  Returns h (B,S,d) f32.

    ``segment > 0`` (when it divides S and S > segment, as in the reference)
    runs each segment of steps through ``models.remat.recompute``: the
    backward keeps the recurrent state at segment boundaries only and
    recomputes the steps within, under ``backward()`` and ``torch.func``
    alike.  The values are the loop's; the gradient of ``r`` sums the steps
    a segment at a time, so it may differ from ``segment = 0`` in the last
    bits."""
    bsz, s, d4 = x_pre.shape
    d = d4 // 4
    pre = x_pre.to(torch.float32)
    dev = x_pre.device
    z = torch.zeros((bsz, d), dtype=torch.float32, device=dev)
    carry = (z, z, torch.full((bsz, d), -1e30, dtype=torch.float32, device=dev), z)

    def run(pre_seg, rec, c, n, m, h):
        hs = []
        for t in range(pre_seg.shape[1]):
            c, n, m, h = _slstm_step(rec, n_heads, hd, c, n, m, h, pre_seg[:, t])
            hs.append(h)
        return c, n, m, h, torch.stack(hs, dim=1)

    rec = {"r": params["r"]}  # all the steps read of the parameters
    if segment and s % segment == 0 and s > segment:
        pieces = []
        for t0 in range(0, s, segment):
            *carry, hs = remat.recompute(run, pre[:, t0 : t0 + segment], rec, *carry)
            pieces.append(hs)
        return torch.cat(pieces, dim=1)
    return run(pre, rec, *carry)[-1]


def _slstm_ffn(params: dict, cfg: ArchConfig, h):
    h = rms_norm(h, params["norm_scale"], cfg.norm_eps)
    ff = (h @ params["ffn_up"]) * F.silu(h @ params["ffn_gate"])
    return ff @ params["ffn_down"]


def slstm_block(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    hd = cfg.d_model // cfg.n_heads
    pre = x @ params["w_in"] + params["bias"][None, None]
    h = _slstm_cell(params, pre, cfg.n_heads, hd, segment=cfg.slstm_segment).to(x.dtype)
    return _slstm_ffn(params, cfg, h)


def init_slstm_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), -1e30, **f32), "h": torch.zeros((batch, d), **f32)}


def slstm_decode_step(params: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """x (B,1,d) -> (y (B,1,d), state), the state updated in place."""
    hd = cfg.d_model // cfg.n_heads
    pre = (x[:, 0] @ params["w_in"] + params["bias"][None]).to(torch.float32)
    c, n, m, h = _slstm_step(params, cfg.n_heads, hd, state["c"], state["n"], state["m"],
                             state["h"], pre)
    y = _slstm_ffn(params, cfg, h[:, None].to(x.dtype))
    for name, new in (("c", c), ("n", n), ("m", m), ("h", h)):
        state[name].copy_(new)
    return y, state


# ---------------------------------------------------------------------------
# chunkwise-parallel mLSTM
# ---------------------------------------------------------------------------


def mlstm_chunked(q, k, v, i_gate, f_gate, chunk: int = 128):
    """Chunkwise-parallel stabilised mLSTM, the same function as
    ``_mlstm_cell``.

    With LF'_t the chunk-local cumulative log forget and a'_s = li_s - LF'_s,
    the cell's running stabiliser is m_t = LF'_t + M_t with
    M_t = max(m_in, cummax(a')_t), and the m-normalised unrolled weights are
    w[t,s] = exp(a'_s - M_t): each chunk is two products over a (Q, Q) decay
    matrix plus the carried state's contribution, and the (hd x hd) state
    and normaliser are carried only at chunk boundaries.

    q, k, v (B,S,H,hd), q and k scaled by hd^-0.5 inside as ``_mlstm_cell``
    scales them; gates (B,S,H) pre-activation.  Returns (h (B,S,H,hd) in
    q's dtype, (C~, n~, m) the final state)."""
    bsz, s, h, hd = q.shape
    qc = min(chunk, s)
    while s % qc:
        qc //= 2
    nc = s // qc

    scale = hd**-0.5
    qf = (q.to(torch.float32) * scale).reshape(bsz, nc, qc, h, hd)
    kf = (k.to(torch.float32) * scale).reshape(bsz, nc, qc, h, hd)
    vf = v.to(torch.float32).reshape(bsz, nc, qc, h, hd)
    lf = F.logsigmoid(f_gate.to(torch.float32)).reshape(bsz, nc, qc, h)
    li = i_gate.to(torch.float32).reshape(bsz, nc, qc, h)

    lf_cum = torch.cumsum(lf, dim=2)  # LF'_t inclusive (B,nc,Q,H)
    a = li - lf_cum  # a'_s
    causal = torch.tril(torch.ones((qc, qc), dtype=torch.bool, device=q.device))

    dev = q.device
    c_in = torch.zeros((bsz, h, hd, hd), dtype=torch.float32, device=dev)
    n_in = torch.zeros((bsz, h, hd), dtype=torch.float32, device=dev)
    m_in = torch.full((bsz, h), -1e30, dtype=torch.float32, device=dev)
    hs = []
    for ci in range(nc):
        q_c, k_c, v_c, lfc_c, a_c = qf[:, ci], kf[:, ci], vf[:, ci], lf_cum[:, ci], a[:, ci]
        m_big = torch.maximum(torch.cummax(a_c, dim=1).values, m_in[:, None, :])  # (B,Q,H)
        # intra-chunk weights w[t,s] = exp(a'_s - M_t), s <= t
        dmat = torch.exp(a_c[:, None, :, :] - m_big[:, :, None, :])  # (B,t,s,H)
        dmat = torch.where(causal[None, :, :, None], dmat, 0.0)
        qk = torch.einsum("bthd,bshd->btsh", q_c, k_c)
        num = torch.einsum("btsh,bshd->bthd", qk * dmat, v_c)
        inter = torch.exp(m_in[:, None, :] - m_big)  # (B,t,H)
        num = num + inter[..., None] * torch.einsum("bthk,bhvk->bthv", q_c, c_in)
        n_vec = torch.einsum("btsh,bshd->bthd", dmat, k_c) + inter[..., None] * n_in[:, None]
        m_t = lfc_c + m_big  # (B,Q,H)
        denom = torch.maximum(torch.abs(torch.sum(n_vec * q_c, dim=-1)), torch.exp(-m_t))
        hs.append(num / denom[..., None])

        # chunk-exit state (normalised by exp(m at chunk end))
        m_end = m_big[:, -1]  # (B,H)
        w_exit = torch.exp(a_c - m_end[:, None, :])  # (B,s,H)
        c_out = torch.einsum("bsh,bshv,bshk->bhvk", w_exit, v_c, k_c)
        n_out = torch.einsum("bsh,bshk->bhk", w_exit, k_c)
        keep = torch.exp(m_in - m_end)
        c_in = c_out + keep[..., None, None] * c_in
        n_in = n_out + keep[..., None] * n_in
        m_in = lfc_c[:, -1] + m_end  # cell-equivalent m at chunk end
    out = torch.stack(hs, dim=1).reshape(bsz, s, h, hd)
    return out.to(q.dtype), (c_in, n_in, m_in)
