"""Shared model machinery: the generic ``ArchConfig`` and its primitives.

The port's own copy of ``repro/models/common.py``.  One configuration
dataclass describes every architecture of the zoo.  ``param_dtype`` is a torch
dtype.  ``rms_norm`` runs kernel 6 (``kernels.ops.rmsnorm``: the CUDA kernel
for a tensor on the GPU, its plain version on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels import ops

__all__ = ["ArchConfig", "rms_norm", "apply_rope", "rope_angles", "softcap", "uniform_init"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads

    # layer composition: cycled across layers; len must divide n_layers
    block_pattern: tuple[str, ...] = ("attn",)

    # attention details
    rope_theta: float = 10000.0
    sliding_window: int | None = None  # used by "attn_local" blocks
    attn_softcap: float | None = None  # gemma2 attention-logit soft capping
    final_softcap: float | None = None  # gemma2 output-logit soft capping
    qk_norm: bool = False  # qwen3 per-head q/k RMSNorm

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25

    # SSM (Mamba2 / xLSTM)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 0

    # encoder-decoder / multimodal
    encoder_layers: int = 0
    cross_attn_every: int = 0
    frontend: str | None = None  # "audio" | "vision"
    frontend_seq: int = 0
    frontend_dim: int = 0
    scale_embed: bool = False  # gemma2: h *= sqrt(d_model)

    # numerics
    param_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = True

    # federated execution (the reference's round; not used by serving)
    round_mode: str = "client_parallel"  # or "cohort_sequential"
    long_context_ok: bool = False
    remat: str = "full"  # "full" | "none": recompute each pattern group (models.remat)
    attn_impl: str = "einsum"  # the port runs full-sequence attention through kernel 7 either way
    moe_impl: str = "dense"
    mlstm_impl: str = "scan"
    mlstm_chunk: int = 128
    slstm_segment: int = 0  # > 0: recompute the sLSTM loop a segment at a time in the backward

    # provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def pattern_repeats(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: pattern {self.block_pattern} must divide {self.n_layers} layers"
            )
        return self.n_layers // len(self.block_pattern)

    def param_count(self, params) -> int:
        from repro_torch.fed.tasks import tree_leaves

        return sum(int(x.numel()) for x in tree_leaves(params))

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests (the reference's
        sizes, f32).  A ``param_dtype`` override may name the dtype
        (``"bfloat16"``), as a spec's JSON kwargs do."""
        n_pat = len(self.block_pattern)
        small = dict(
            n_layers=max(n_pat, 2 if n_pat == 1 else n_pat),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=32 if self.head_dim else None,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            frontend_seq=min(self.frontend_seq, 16) if self.frontend_seq else 0,
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            param_dtype=torch.float32,
            name=self.name + "-reduced",
        )
        small.update(overrides)
        if isinstance(small["param_dtype"], str):
            small["param_dtype"] = getattr(torch, small["param_dtype"])
        return dataclasses.replace(self, **small)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (f32 math, x's dtype): one launch of
    kernel 6 over the (rows, D) view."""
    return ops.rmsnorm(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables, (..., head_dim / 2) f32, for integer positions."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(float(theta), exps)  # a scalar base: no host-to-device copy
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., head_dim) with cos/sin broadcastable to (..., head_dim / 2):
    rotate the split halves in f32, cast back to x's dtype."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def uniform_init(gen: torch.Generator | None, shape, dtype, scale: float | None = None) -> torch.Tensor:
    """U(-1, 1) * scale (default 1/sqrt(fan_in)) on the generator's device,
    drawn in f32 and cast to ``dtype``.  ``gen=None`` gives an unallocated
    tensor on the ``meta`` device (shapes only)."""
    shape = tuple(shape)
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    # In place, the same ops in the same order: one f32 temporary a leaf, not
    # three (arctic's 4.46e9-element expert leaves are 17.8 GB each in f32).
    return u.mul_(2.0).sub_(1.0).mul_(scale).to(dtype)
