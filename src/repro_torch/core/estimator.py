"""Unbiased global estimation (Definition 2.1) and variance diagnostics.

The server-side estimate of the full-participation update

    d^t = sum_{i in S^t} lambda_i g_i^t / p_i^t          (ISP, mask form)

operates on stacked parameter dicts whose leaves lead with a client (or
cohort-slot) axis.  The aggregation entry points flatten the stacked deltas
into one (C, D) f32 buffer in the reference's tree order (dict keys sorted at
every level), so the buffer is the same array as the JAX package's, and hand
it to ``kernels.fused_weighted_agg``: the CUDA kernel for a tensor on the
GPU (any D), the plain PyTorch version for one on the CPU.
``aggregate_compressed`` quantizes that buffer to int8 or fp8 first and
aggregates the codes with ``fused_dequant_cohort_agg``.

With a ``shard`` that splits the client axis over S > 1 ranks, each rank
passes its block of clients or slots and gets the global result back: the
partial (D,) sums are ``all_reduce``d, and a squared norm of a sum, which
is not additive across ranks, is taken after the reduce (kernel 1 with rows
``w`` and ``w - lam`` in place of kernel 2's fused norm; two launches of
kernel 4, the second with weights ``w - lam``).  Per-slot norms stay local.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.samplers import SampleResult
from repro_torch.fed.tasks import tree_leaves, tree_map
from repro_torch.kernels.fused_weighted_agg import (
    fused_cohort_agg_and_error,
    fused_dequant_cohort_agg,
    fused_multi_weighted_agg,
    quantize_stacked,
)

__all__ = [
    "client_weights",
    "aggregate_stacked",
    "full_aggregate_stacked",
    "flatten_stacked",
    "unflatten_vector",
    "aggregate_and_error",
    "aggregate_and_error_cohort",
    "aggregate_cohort",
    "aggregate_compressed",
    "isp_variance",
    "rsp_variance_bound",
    "empirical_sq_error",
]


def client_weights(
    draw: SampleResult, lam: torch.Tensor, procedure: str, budget: int
) -> torch.Tensor:
    """Scalar aggregation coefficient per client (zero for unsampled): the
    estimator is ``d = sum_i w_i g_i``.  ISP and uniform RSP without
    replacement: ``lam / p`` for the included clients; RSP with
    replacement: ``counts * lam / (K q)``, q the per-draw probability.  A
    draw whose probabilities were composed upstream (the fault layer's
    ``stragglers.available_draw``) gets the corrected weights as they are.
    The 1e-30 floors only guard the masked-out lanes."""
    if procedure in ("isp", "rsp_wor"):
        return torch.where(draw.mask, lam / torch.clamp(draw.marginals, min=1e-30), 0.0)
    if procedure == "rsp_wr":
        q = torch.clamp(draw.draw_probs, min=1e-30)
        return draw.counts.to(lam.dtype) * lam / (budget * q)
    raise ValueError(f"unknown procedure {procedure!r}")


def aggregate_stacked(updates, weights: torch.Tensor):
    """d = sum_i w_i * g_i over a stacked dict (leading client axis), in each
    leaf's dtype."""

    def agg(leaf):
        w = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return (w * leaf).sum(0)

    return tree_map(agg, updates)


def full_aggregate_stacked(updates, lam: torch.Tensor):
    """Full-participation target sum_i lambda_i g_i."""
    return aggregate_stacked(updates, lam)


def flatten_stacked(updates, dtype: torch.dtype | None = torch.float32):
    """Stacked dict (leading axis C; nested dicts and lists) -> (C, D) in
    tree order + the spec to rebuild a (D,) vector: the tree with each leaf
    replaced by a ``meta`` tensor of its per-slot shape and dtype.  The
    buffer is ``dtype``, or with ``dtype=None`` the leaves' promoted dtype."""
    spec = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"), updates)
    leaves = tree_leaves(updates)
    flat = torch.cat([x.reshape(x.shape[0], -1) for x in leaves], dim=1)
    return (flat if dtype is None else flat.to(dtype)), spec


def unflatten_vector(vec: torch.Tensor, spec) -> dict:
    """(D,) vector -> the tree of ``flatten_stacked``'s spec, each leaf cast
    to its input dtype."""
    off = 0

    def walk(tree):
        nonlocal off
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        size = math.prod(tree.shape)
        out = vec[off : off + size].reshape(tree.shape).to(tree.dtype)
        off += size
        return out

    return walk(spec)


def _splitting(shard) -> bool:
    return shard is not None and shard.splits


def aggregate_and_error(updates, weights: torch.Tensor, lam: torch.Tensor, *, shard=None):
    """Estimate ``d = sum_i w_i g_i`` AND its squared error against the
    full-participation target ``sum_i lambda_i g_i`` in ONE pass over the
    stacked updates: the (2, N) x (N, D) contraction of the two weight rows
    [w, w - lam] with the flattened deltas (kernel ``fused_multi_weighted_agg``).
    With a splitting ``shard`` the rows are this rank's clients and the
    (2, D) partials are ``all_reduce``d before the norm.

    Returns (estimate dict, 0-d squared error).
    """
    flat, spec = flatten_stacked(updates)
    w = weights.to(torch.float32)
    w2 = torch.stack([w, w - lam.to(torch.float32)])
    out = fused_multi_weighted_agg(flat, w2)
    if _splitting(shard):
        out = shard.sum(out)
    return unflatten_vector(out[0], spec), (out[1] ** 2).sum()


def aggregate_cohort(updates, weights: torch.Tensor, *, shard) -> dict:
    """``sum_c w_c delta_c`` over this rank's slots, ``all_reduce``d over
    the shards, as an f32 dict: kernel ``fused_cohort_agg_and_error`` on
    the stacked deltas at their own width (f32 or bf16), its error row
    unused (``lam = w``)."""
    flat, spec = flatten_stacked(updates, dtype=None)
    w = weights.to(torch.float32)
    d_vec, _ = fused_cohort_agg_and_error(flat, w, w)
    spec32 = tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32, device="meta"), spec)
    return unflatten_vector(shard.sum(d_vec), spec32)


def aggregate_and_error_cohort(
    updates, weights: torch.Tensor, lam_cohort: torch.Tensor, *, shard=None
):
    """Cohort-width ``aggregate_and_error``: (C, ...) stacked cohort deltas,
    ``weights`` from ``fed.cohort.select_cohort`` (zero on padding) and
    ``lam_cohort`` (lambda at the cohort ids, zero on padding).  Nothing
    (N, D)-shaped exists; kernel ``fused_cohort_agg_and_error`` squares and
    reduces the error row on chip.

    With a splitting ``shard`` the slots are this rank's: kernel 1 takes
    the rows ``w`` and ``w - lam`` and the (2, D) partials are
    ``all_reduce``d before the norm.

    Returns (estimate dict, 0-d squared error
    ``||sum_c (w_c - lam_c) delta_c||^2``).
    """
    if _splitting(shard):
        return aggregate_and_error(updates, weights, lam_cohort, shard=shard)
    flat, spec = flatten_stacked(updates)
    d_vec, sq = fused_cohort_agg_and_error(
        flat, weights.to(torch.float32), lam_cohort.to(torch.float32)
    )
    return unflatten_vector(d_vec, spec), sq


def aggregate_compressed(
    updates, weights: torch.Tensor, lam_cohort: torch.Tensor, compression, resid=None, *,
    shard=None,
):
    """Compressed-width ``aggregate_and_error_cohort``: quantize the stacked
    deltas to ``compression.delta_dtype`` with one f32 scale per (slot,
    ``compression.scale_block``) block, then aggregate the codes with kernel
    ``fused_dequant_cohort_agg``, which widens them in registers, so the
    (C, D) buffer is read once at quantized width.

    ``resid`` (D,) f32 turns on server-side error feedback: the applied
    estimate is ``d_hat + resid`` and the returned ``new_resid`` is the fresh
    quantization error ``d_true - d_hat`` (``d_true`` the uncompressed
    aggregate of the f32 deltas), so errors telescope instead of
    accumulating.  With ``resid=None`` the raw ``d_hat`` is applied and
    ``new_resid`` is None.

    With a splitting ``shard`` the rows are this rank's slots: a second
    launch with weights ``w - lam`` gives the error row, and the estimate,
    the error row and ``w @ flat`` are ``all_reduce``d as one (2 or 3, D)
    tensor before the norm; the norms are this rank's slots'.

    Returns (estimate dict, err_sq () f32, dequantized norms (C,) f32,
    new_resid (D,) f32 | None).  ``err_sq`` and the norms come from the
    dequantized values, so the sampler's feedback is what the estimator saw.
    """
    flat, spec = flatten_stacked(updates)
    w = weights.to(torch.float32)
    lam = lam_cohort.to(torch.float32)
    q, scales = quantize_stacked(
        flat, dtype=compression.delta_dtype, scale_block=int(compression.scale_block)
    )
    d_vec, sq, sqn = fused_dequant_cohort_agg(q, scales, w, lam)
    d = flat.shape[1]
    d_hat = d_vec[:d]
    if _splitting(shard):
        e_vec, _, _ = fused_dequant_cohort_agg(q, scales, w - lam, torch.zeros_like(lam))
        rows = [d_hat, e_vec[:d]] + ([w @ flat] if resid is not None else [])
        red = shard.sum(torch.stack(rows))
        d_hat, sq = red[0], (red[1] ** 2).sum()
        true_sum = red[2] if resid is not None else None
    elif resid is not None:
        true_sum = w @ flat
    new_resid = None
    if resid is not None:
        new_resid = true_sum - d_hat
        d_hat = d_hat + resid
    return unflatten_vector(d_hat, spec), sq, torch.sqrt(sqn), new_resid


def isp_variance(scores: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Exact ISP estimator variance (Lemma 2.1, equality case):
    V(S) = sum_i (1 - p_i) * a_i^2 / p_i,   a_i = lambda_i ||g_i||."""
    return ((1.0 - p) * scores**2 / torch.clamp(p, min=1e-30)).sum()


def rsp_variance_bound(scores: torch.Tensor, p: torch.Tensor, budget: int) -> torch.Tensor:
    """RSP upper bound of Lemma 2.1: (N-K)/(N-1) * sum_i a_i^2 / p_i."""
    n = scores.shape[0]
    coef = (n - budget) / max(n - 1, 1)
    return coef * (scores**2 / torch.clamp(p, min=1e-30)).sum()


def empirical_sq_error(estimate, target) -> torch.Tensor:
    """|| d - sum lambda g ||^2 across a parameter dict."""
    terms = [
        ((a.to(torch.float32) - b.to(torch.float32)) ** 2).sum()
        for a, b in zip(tree_leaves(estimate), tree_leaves(target))
    ]
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total
