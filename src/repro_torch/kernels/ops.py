"""Public wrappers for the port's kernels, after ``repro/kernels/ops.py``.

Every wrapper of the reference is here, ``flash_attention_trainable``
included: its forward is kernel 7 and its gradient the PyTorch backward of
``kernels.flash_attention`` (a port of the reference's ``_fa_bwd``).

As everywhere in the port, a tensor on the CPU takes the kernel's plain
PyTorch version and a tensor on a CUDA device launches the CUDA kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.estimator import flatten_stacked, unflatten_vector
from repro_torch.kernels import fused_weighted_agg as _fwa
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.sharded_waterfill import waterfill_level_stats
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = [
    "flash_attention",
    "flash_attention_trainable",
    "ssd_scan",
    "fused_weighted_agg",
    "rmsnorm",
    "aggregate_cohort_updates",
    "waterfill_level_stats",
]


def flash_attention_trainable(q, k, v, causal=True, window=None, softcap=None):
    """Flash attention with a gradient, the reference's signature and
    meaning: q, k, v (H, S, hd); forward through kernel 7 (O(S) memory, no
    S x S probabilities stored), backward recomputing attention from (q, k,
    v, out) with the analytic gradient.  The reference's custom VJP is the
    ``torch.autograd.Function`` behind ``flash_attention``, so this is that
    call with the reference's positional flags."""
    return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)


def fused_weighted_agg(g: torch.Tensor, w: torch.Tensor, *, block_d: int = 2048):
    """g (C, D) f32|bf16, w (C,) f32 -> (d (D,) f32, sq_norms (C,) f32).

    ``block_d`` is accepted for signature parity with the reference, whose
    Pallas kernel tiles D by it; the CUDA kernel takes any D and
    ``block_d`` does not change the result."""
    if int(block_d) < 1:
        raise ValueError(f"block_d must be positive, got {block_d}")
    return _fwa.fused_weighted_agg(g, w)


def aggregate_cohort_updates(stacked_deltas, weights: torch.Tensor, *, block_d: int = 2048):
    """Dict-level driver of ``fused_weighted_agg``: flattens a stacked client
    update dict (leading client axis; leaves in the reference's tree order,
    keys sorted), runs one fused pass, and returns (delta dict, sq_norms (C,)).
    Each output leaf has its input leaf's dtype.

    This is the deployable server aggregation of Algorithm 1, lines 12 and
    14, in one read of the deltas.  Unlike the reference it pads nothing:
    ``block_d`` does not change the result."""
    flat, spec = flatten_stacked(stacked_deltas, dtype=None)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.to(torch.float32)
    w = weights.to(torch.float32).contiguous()
    d_flat, sq = fused_weighted_agg(flat, w, block_d=block_d)
    return unflatten_vector(d_flat, spec), sq
