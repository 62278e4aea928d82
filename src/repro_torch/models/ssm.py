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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
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


def mamba2_block(params: dict, cfg: ArchConfig, x: torch.Tensor, chunk: int = 128,
                 return_state: bool = False):
    """x (B,S,d) -> y (B,S,d), and with ``return_state`` the final
    {"conv", "ssm"} state.  The chunk is the reference's: min(chunk, S),
    halved until it divides S."""
    bsz, s, _ = x.shape
    proj = x @ params["in_proj"]
    z, xbc_raw, dt, d_in, n, n_heads = _split_proj(cfg, proj)
    xbc, conv_tail = _causal_conv(xbc_raw, params["conv_w"])
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(bsz, s, n_heads, cfg.ssm_head_dim)
    b = xbc[..., d_in : d_in + n]
    c = xbc[..., d_in + n :]
    dt = dt + params["dt_bias"][None, None, :]
    ch = min(chunk, s)
    while s % ch:
        ch //= 2
    out = ssd_chunked(xs, dt, params["a_log"], b, c, params["d_skip"], chunk=max(ch, 1),
                      return_state=return_state)
    y, ssm_state = out if return_state else (out, None)
    y = y.reshape(bsz, s, d_in)
    y = rms_norm(y, params["norm_scale"], cfg.norm_eps) * F.silu(z)
    y = y @ params["out_proj"]
    if return_state:
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


def mamba2_decode_step(params: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """x (B,1,d) -> (y (B,1,d), state).  O(1) per token; ``state``'s conv
    and ssm tensors are updated in place and the same dict is returned."""
    bsz = x.shape[0]
    proj = x @ params["in_proj"]
    z, xbc, dt, d_in, n, n_heads = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], state["conv"])
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(bsz, n_heads, cfg.ssm_head_dim).to(torch.float32)
    b = xbc[:, 0, d_in : d_in + n].to(torch.float32)  # (B,N)
    c = xbc[:, 0, d_in + n :].to(torch.float32)
    dtf = F.softplus((dt[:, 0] + params["dt_bias"][None]).to(torch.float32))  # (B,H)
    af = -torch.exp(params["a_log"].to(torch.float32))
    decay = torch.exp(dtf * af[None])  # (B,H)
    h = state["ssm"] * decay[..., None, None] + xs[..., :, None] * b[:, None, None, :] * dtf[..., None, None]
    y = torch.einsum("bhdn,bn->bhd", h, c)
    y = y + params["d_skip"][None, :, None] * xs
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rms_norm(y, params["norm_scale"], cfg.norm_eps) * F.silu(z)
    state["conv"].copy_(conv_state)
    state["ssm"].copy_(h)
    return y @ params["out_proj"], state
