"""Unbiased global estimation (Definition 2.1) and variance diagnostics.

The server-side estimate of the full-participation update

    d^t = sum_{i in S^t} lambda_i g_i^t / p_i^t          (ISP, mask form)

operates on stacked parameter dicts whose leaves lead with a client (or
cohort-slot) axis.  Both aggregation entry points flatten the stacked deltas
into one (C, D) f32 buffer in the reference's tree order (dict keys sorted at
every level), so the buffer is the same array as the JAX package's, and hand
it to ``kernels.fused_weighted_agg``: the CUDA kernel for a tensor on the
GPU (any D), the plain PyTorch version for one on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.samplers import SampleResult
from repro_torch.fed.tasks import tree_leaves
from repro_torch.kernels.fused_weighted_agg import (
    fused_cohort_agg_and_error,
    fused_multi_weighted_agg,
)

__all__ = [
    "client_weights",
    "aggregate_and_error",
    "aggregate_and_error_cohort",
    "isp_variance",
    "rsp_variance_bound",
    "empirical_sq_error",
]


def client_weights(
    draw: SampleResult, lam: torch.Tensor, procedure: str, budget: int
) -> torch.Tensor:
    """Scalar aggregation coefficient per client (zero for unsampled): the
    estimator is ``d = sum_i w_i g_i``.  The 1e-30 floor only guards the
    masked-out lanes."""
    if procedure == "isp":
        return torch.where(draw.mask, lam / torch.clamp(draw.marginals, min=1e-30), 0.0)
    raise NotImplementedError(
        f"procedure {procedure!r} is not ported (only 'isp'); see ROADMAP.md "
        "queue 1, 'Samplers'"
    )


def _flatten_stacked(updates):
    """Stacked dict (leading axis C) -> (C, D) f32 in tree order + the
    (key path, shape, dtype) spec to rebuild a (D,) vector."""
    spec = []

    def walk(tree, path):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                spec.append((path + (k,), tuple(v.shape[1:]), v.dtype))

    walk(updates, ())
    leaves = tree_leaves(updates)
    flat = torch.cat([x.reshape(x.shape[0], -1).to(torch.float32) for x in leaves], dim=1)
    return flat, spec


def _unflatten_vector(vec: torch.Tensor, spec) -> dict:
    out: dict = {}
    off = 0
    for path, shape, dtype in spec:
        size = math.prod(shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = vec[off : off + size].reshape(shape).to(dtype)
        off += size
    return out


def aggregate_and_error(updates, weights: torch.Tensor, lam: torch.Tensor):
    """Estimate ``d = sum_i w_i g_i`` AND its squared error against the
    full-participation target ``sum_i lambda_i g_i`` in ONE pass over the
    stacked updates: the (2, N) x (N, D) contraction of the two weight rows
    [w, w - lam] with the flattened deltas (kernel ``fused_multi_weighted_agg``).

    Returns (estimate dict, 0-d squared error).
    """
    flat, spec = _flatten_stacked(updates)
    w = weights.to(torch.float32)
    w2 = torch.stack([w, w - lam.to(torch.float32)])
    out = fused_multi_weighted_agg(flat, w2)
    return _unflatten_vector(out[0], spec), (out[1] ** 2).sum()


def aggregate_and_error_cohort(updates, weights: torch.Tensor, lam_cohort: torch.Tensor):
    """Cohort-width ``aggregate_and_error``: (C, ...) stacked cohort deltas,
    ``weights`` from ``fed.cohort.select_cohort`` (zero on padding) and
    ``lam_cohort`` (lambda at the cohort ids, zero on padding).  Nothing
    (N, D)-shaped exists; kernel ``fused_cohort_agg_and_error`` squares and
    reduces the error row on chip.

    Returns (estimate dict, 0-d squared error
    ``||sum_c (w_c - lam_c) delta_c||^2``).
    """
    flat, spec = _flatten_stacked(updates)
    d_vec, sq = fused_cohort_agg_and_error(
        flat, weights.to(torch.float32), lam_cohort.to(torch.float32)
    )
    return _unflatten_vector(d_vec, spec), sq


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
