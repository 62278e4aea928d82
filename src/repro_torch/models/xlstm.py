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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import remat
from repro_torch.models.common import ArchConfig, rms_norm, uniform_init
from repro_torch.models.ssm import _causal_conv

__all__ = [
    "mlstm_chunked",
    "init_mlstm",
    "mlstm_block",
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


def _mlstm_step(c, n, m, q_t, k_t, v_t, lf, li):
    """One stabilised mLSTM step: c (B,H,hd,hd), n (B,H,hd), m (B,H); q_t,
    k_t, v_t (B,H,hd) f32, q and k pre-scaled; lf, li (B,H) log forget and
    input gates.  Returns (c, n, m, h_t (B,H,hd))."""
    m_new = torch.maximum(lf + m, li)
    f_s = torch.exp(lf + m - m_new)[..., None]  # (B,H,1)
    i_s = torch.exp(li - m_new)[..., None]
    # (i v) k^T, not i (v k^T): the backward then keeps no (hd, hd) outer
    # product a step, only C itself (the next step's input); training at
    # xlstm-125m's width holds 64 steps x 6 blocks of these.
    c = c * f_s[..., None] + (i_s * v_t)[..., :, None] * k_t[..., None, :]
    n = n * f_s + i_s * k_t
    denom = torch.maximum(torch.abs(torch.sum(n * q_t, dim=-1, keepdim=True)),
                          torch.exp(-m_new)[..., None])
    h_t = torch.einsum("bhvk,bhk->bhv", c, q_t) / denom
    return c, n, m_new, h_t


def _mlstm_cell(q, k, v, i_gate, f_gate):
    """Stabilised mLSTM recurrence.  q, k, v (B,S,H,hd); gates (B,S,H)
    pre-activation.  Returns h (B,S,H,hd) f32."""
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
    m = torch.full((bsz, h), -torch.inf, dtype=torch.float32, device=dev)
    hs = []
    for t in range(s):
        c, n, m, h_t = _mlstm_step(c, n, m, qf[:, t], kf[:, t], vf[:, t], logf[:, t], logi[:, t])
        hs.append(h_t)
    return torch.stack(hs, dim=1)


def _mlstm_qkv_gates(params: dict, cfg: ArchConfig, x: torch.Tensor, conv_state=None):
    """The block's projections: (z, q, k, v (B,S,H,hd) in x's dtype, i and f
    gate pre-activations (B,S,H) f32, the new conv state)."""
    bsz, s, d = x.shape
    d_in = 2 * d
    hd = d_in // cfg.n_heads
    up = x @ params["up"]
    xi, z = up[..., :d_in], up[..., d_in:]
    xc, conv_state = _causal_conv(xi, params["conv_w"], conv_state)
    xc = F.silu(xc)
    q = (xc @ params["wq"]).reshape(bsz, s, cfg.n_heads, hd)
    k = (xc @ params["wk"]).reshape(bsz, s, cfg.n_heads, hd)
    v = (xi @ params["wv"]).reshape(bsz, s, cfg.n_heads, hd)
    gates = (xi @ params["w_if"] + params["if_bias"][None, None]).reshape(bsz, s, 2, cfg.n_heads)
    return z, q, k, v, gates[:, :, 0], gates[:, :, 1], conv_state


def _mlstm_out(params: dict, cfg: ArchConfig, h, z, x_dtype):
    """Inner norm (kernel 6), output gate, down projection."""
    h = rms_norm(h.to(x_dtype), params["norm_scale"], cfg.norm_eps) * F.silu(z)
    return h @ params["down"]


def mlstm_block(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    bsz, s, d = x.shape
    z, q, k, v, i_gate, f_gate, _ = _mlstm_qkv_gates(params, cfg, x)
    if cfg.mlstm_impl == "chunked":
        h, _ = mlstm_chunked(q, k, v, i_gate, f_gate, chunk=cfg.mlstm_chunk)
    else:
        h = _mlstm_cell(q, k, v, i_gate, f_gate)
    return _mlstm_out(params, cfg, h.reshape(bsz, s, 2 * d), z, x.dtype)


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


def mlstm_decode_step(params: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """x (B,1,d) -> (y (B,1,d), state), the state updated in place."""
    bsz = x.shape[0]
    d_in = 2 * cfg.d_model
    hd = d_in // cfg.n_heads
    z, q, k, v, i_gate, f_gate, conv_state = _mlstm_qkv_gates(params, cfg, x, state["conv"])
    scale = hd**-0.5
    q = q[:, 0].to(torch.float32) * scale
    k = k[:, 0].to(torch.float32) * scale
    v = v[:, 0].to(torch.float32)
    logi = i_gate[:, 0].to(torch.float32)
    logf = F.logsigmoid(f_gate[:, 0].to(torch.float32))
    c, n, m, h = _mlstm_step(state["c"], state["n"], state["m"], q, k, v, logf, logi)
    y = _mlstm_out(params, cfg, h.reshape(bsz, 1, d_in), z, x.dtype)
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
