"""Mamba2 (SSD) block: the port of ``repro/models/ssm.py``, same names.

Prefill and training run the chunked scan (Dao & Gu 2024): within a chunk
the recurrence is a small masked quadratic form, across chunks a carried
(hd, N) state.  The port runs it as kernel 8 (``kernels.ops.ssd_scan``: the
CUDA kernel on the GPU, its plain version on the CPU) where the reference
runs its own jnp ``ssd_chunked``; both compute the same function.  Decode is
the O(1) single-token recurrence in plain torch, as in the reference.  The
gated norm over d_in goes through kernel 6 (``models.common.rms_norm``).

State-space shapes (n_groups = 1, B and C shared across heads):
  x   (B, S, H, hd)      dt (B, S, H)       A  (H,) negative scalars
  B,C (B, S, N)          recurrent state (B, H, hd, N) f32

``mamba2_decode_step`` writes the new conv and SSM states into the state
dict it is given, in place (the serving engine's caches keep their
addresses), and returns that dict.

Under ``models.sharding.use_rules`` a block may hold this rank's blocks of
its projections over the ``model`` line (``line``, chosen by
``models/transformer.py:_split_cells``; the reference's
``"state"`` rule, ``shard(xs, "batch", "seq", "state", None)``): columns of
``in_proj``, channels of ``conv_w``, rows of ``out_proj``.  It then
computes the heads of its block where they lie, and no weight is gathered:
a rank's column block of the projection gives a block of its output, and
each rank receives, by one all_to_all (``sharding.take_columns``), the
columns it uses: z and dt of its heads (dt of every head in decode) and
the conv's channel block; the conv's output likewise (x of its heads, b
and c whole; in decode all of it, gathered); the heads' outputs are
gathered for the gated norm, which stays kernel 6 over the whole d_in row,
and the row block of ``out_proj`` gives a partial product, summed in f32
(``sharding.row_block_matmul``).  In training
and prefill kernel 8 runs on the rank's H / m heads with b and c whole; a
prefill's final state goes from the heads to the cache's layout by one
all_to_all (``layout``).  A decode step updates the state in the layout
its cache has (``layout``: the dimension of each state leaf split over the
line, or None): every head's inputs are whole there, the state's block
takes its slice of them, and ``y`` is the blocks' partial sums all-reduced
(an N block) or gathered (a head or hd block).  With ``line`` None (no
mesh, or a line that does not divide the heads, whose leaves
``models/transformer.py`` gathers whole) the code is the unsplit one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import sharding as msh
from repro_torch.models.common import ArchConfig, rms_norm, uniform_init

__all__ = [
    "init_mamba2",
    "mamba2_block",
    "mamba2_decode_step",
    "init_mamba2_state",
    "ssd_chunked",
]


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int = 128, return_state: bool = False):
    """SSD scan.  x (B,S,H,hd); dt (B,S,H); a_log (H,); b, c (B,S,N).

    Returns y (B,S,H,hd) in x's dtype and, with ``return_state``, the final
    recurrent state (B,H,hd,N) f32.  Kernel 8 reads the f32 dt-weighted
    inputs and log decays as (B, H, S, ·) views and b, c shared by the H
    heads; y comes back in (B, S, H, hd) memory order."""
    bsz, s, h, hd = x.shape
    if s % chunk:
        raise ValueError(f"S={s} must be a multiple of chunk={chunk}")
    af = -torch.exp(a_log.to(torch.float32))  # (H,) negative
    dtf = F.softplus(dt.to(torch.float32))  # (B,S,H)
    xa = x.to(torch.float32) * dtf[..., None]  # dt-weighted input
    da = dtf * af  # (B,S,H) log decay per step (negative)
    out = ops.ssd_scan(xa.transpose(1, 2), da.transpose(1, 2), b, c, chunk=chunk,
                       return_state=return_state)
    y, state = out if return_state else (out, None)
    y = y.transpose(1, 2) + d_skip.to(torch.float32)[None, None, :, None] * x.to(torch.float32)
    if return_state:
        return y.to(x.dtype), state.reshape(bsz, h, hd, b.shape[-1])
    return y.to(x.dtype)


def init_mamba2(cfg: ArchConfig, gen: torch.Generator | None) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n_heads = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_ch = d_in + 2 * n
    dev = "meta" if gen is None else gen.device
    return {
        # in_proj -> [z (d_in), x (d_in), B (n), C (n), dt (H)]
        "in_proj": uniform_init(gen, (d, 2 * d_in + 2 * n + n_heads), cfg.param_dtype),
        "conv_w": uniform_init(gen, (cfg.conv_width, conv_ch), cfg.param_dtype, scale=0.5),
        "a_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros((d_in,), dtype=cfg.param_dtype, device=dev),
        "out_proj": uniform_init(gen, (d_in, d), cfg.param_dtype),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv, a sum of shifted products (no cuDNN, so no
    TF32).  x (B,S,C); w (W,C); state (B,W-1,C) for decode.  Returns the
    output and the new state: the last W-1 inputs, in x's dtype without a
    state, in the state's dtype with one."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    new_state = xp[:, -(width - 1) :, :]
    if state is not None:
        new_state = new_state.to(state.dtype)
    return out, new_state


def _split_proj(cfg: ArchConfig, proj):
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    n_heads = d_in // cfg.ssm_head_dim
    z = proj[..., :d_in]
    xbc = proj[..., d_in : 2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n :]
    return z, xbc, dt, d_in, n, n_heads


def _used_columns(cfg: ArchConfig, proj, line, every_dt: bool):
    """(z, xbc, dt): the parts of ``in_proj``'s output a rank uses.
    Unsplit, all of them; under ``line``, from ``proj``, this rank's column
    block, by one exchange (``sharding.take_columns``): z of this rank's
    heads, xbc on the conv's channel block, dt of its heads (of every head
    with ``every_dt``)."""
    z, xbc, dt, d_in, n, n_heads = _split_proj(cfg, proj)
    if line is None:
        return z, xbc, dt
    zb, cb, hb = d_in // line.size, (d_in + 2 * n) // line.size, n_heads // line.size
    dt0 = 2 * d_in + 2 * n

    def need(j):
        return [(j * zb, (j + 1) * zb), (d_in + j * cb, d_in + (j + 1) * cb),
                (dt0, dt0 + n_heads) if every_dt else (dt0 + j * hb, dt0 + (j + 1) * hb)]

    return msh.take_columns(proj, line, need).split([zb, cb, n_heads if every_dt else hb], -1)


def _gated_out(params: dict, cfg: ArchConfig, y, z, line):
    """The gated norm over the whole d_in row of y (kernel 6) and
    ``out_proj``; under ``line`` this rank's block of the normed row, gated
    by z (this rank's block), against its rows of ``out_proj``
    (``sharding.row_block_matmul``)."""
    y = rms_norm(y, msh.reduce_grad(params["norm_scale"], line), cfg.norm_eps)
    return msh.row_block_matmul(msh.block(y, line) * F.silu(z), params["out_proj"], line)


def mamba2_block(params: dict, cfg: ArchConfig, x: torch.Tensor, chunk: int = 128,
                 return_state: bool = False, line=None, layout=None):
    """x (B,S,d) -> y (B,S,d), and with ``return_state`` the final
    {"conv", "ssm"} state.  The chunk is the reference's: min(chunk, S),
    halved until it divides S.  On this rank's blocks (the module
    docstring) the state is the conv's channel block and the ssm state's
    block along ``layout["ssm"]`` (the heads' final state exchanged)."""
    bsz, s, _ = x.shape
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    n_heads = d_in // cfg.ssm_head_dim
    x = msh.reduce_grad(x, line)
    z, xbc, dt = _used_columns(cfg, x @ params["in_proj"], line, every_dt=False)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"])
    xbc = F.silu(xbc)
    if line is not None:  # x of this rank's heads, b and c whole
        xb = d_in // line.size
        xbc = msh.take_columns(xbc, line, lambda j: [(j * xb, (j + 1) * xb), (d_in, d_in + 2 * n)])
    xs, b, c = xbc.split([xbc.shape[-1] - 2 * n, n, n], -1)
    xs = msh.shard(xs.reshape(bsz, s, -1, cfg.ssm_head_dim), "batch", "seq", "state", None,
                   whole=(None, None, n_heads, None) if line is not None else None)
    dt = dt + msh.block(msh.reduce_grad(params["dt_bias"], line), line)[None, None, :]
    a_log, d_skip = (msh.block(msh.reduce_grad(params[k], line), line)
                     for k in ("a_log", "d_skip"))
    ch = min(chunk, s)
    while s % ch:
        ch //= 2
    out = ssd_chunked(xs, dt, a_log, b, c, d_skip, chunk=max(ch, 1), return_state=return_state)
    y, ssm_state = out if return_state else (out, None)
    (y,) = msh.gather_blocks([y.reshape(bsz, s, -1)], line)
    y = _gated_out(params, cfg, y, z, line)
    if return_state:
        if line is not None:
            ssm_state = msh.redistribute(ssm_state, line, 1, layout["ssm"])
        return y, {"conv": conv_tail, "ssm": ssm_state}
    return y


def init_mamba2_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_ch = d_in + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, n_heads, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode_step(params: dict, cfg: ArchConfig, x: torch.Tensor, state: dict,
                       line=None, layout=None):
    """x (B,1,d) -> (y (B,1,d), state).  O(1) per token; ``state``'s conv
    and ssm tensors are updated in place and the same dict is returned.  On
    this rank's blocks (the module docstring) ``state`` holds the conv's
    channel block and the ssm state's block along ``layout["ssm"]`` (1
    heads, 2 hd, 3 N; None whole)."""
    bsz = x.shape[0]
    at = None if line is None else layout["ssm"]
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    n_heads = d_in // cfg.ssm_head_dim
    z, xbc, dt = _used_columns(cfg, x @ params["in_proj"], line, every_dt=True)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], state["conv"])
    (xbc,) = msh.gather_blocks([F.silu(xbc)], line)
    xs = xbc[..., :d_in].reshape(bsz, n_heads, cfg.ssm_head_dim).to(torch.float32)
    b = xbc[:, 0, d_in : d_in + n].to(torch.float32)  # (B,N)
    c = xbc[:, 0, d_in + n :].to(torch.float32)
    dtf = F.softplus((dt[:, 0] + params["dt_bias"][None]).to(torch.float32))  # (B,H)
    af = -torch.exp(params["a_log"].to(torch.float32))
    decay = torch.exp(dtf * af[None])  # (B,H)

    def on(t, dims: dict):  # t's slice of the state's block: dims maps its split dim to t's
        return t if at not in dims else msh.block(t, line, dims[at])

    h = (state["ssm"] * on(decay, {1: 1})[..., None, None]
         + on(xs, {1: 1, 2: 2})[..., :, None] * on(b, {3: 1})[:, None, None, :]
         * on(dtf, {1: 1})[..., None, None])
    y = torch.einsum("bhdn,bn->bhd", h, on(c, {3: 1}))
    y = msh.all_reduce(y, line) if at == 3 else msh.redistribute(y, line, at, None)
    y = y + params["d_skip"][None, :, None] * xs
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    state["conv"].copy_(conv_state)
    state["ssm"].copy_(h)
    return _gated_out(params, cfg, y, z, line), state
