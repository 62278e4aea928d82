"""Shared padded-cohort contract: selection, padding, and weight semantics.

Port of ``repro/fed/cohort.py`` (see its module docstring for the full
contract).  A round's draw ``S`` (the ``mask``; for an RSP draw the union
of its K draws, whose counts are already in the weights) maps onto a static
buffer of C slots:

* ids     — (C,) client indices; the first ``min(|S|, C)`` slots hold
  included clients in random-priority order, the rest are padding.
* valid   — (C,) bool, True exactly for slots holding included clients.
  Padding slots are inert: zero weight, zero feedback, zero loss share.
* weights — (C,) f32 estimator coefficients (zero on padding).

On overflow (``|S| > C``) a uniformly random size-C subset of ``S`` is kept
(top-k over i.i.d. uniform priorities) and every retained weight is scaled
by ``|S|/C``, which keeps the estimate unbiased.  The priorities come from
the run's random source (``repro_torch.rng``).

``torch.topk`` orders equal priorities differently from ``lax.top_k``.  The
ties are the -1 priorities of non-included clients, i.e. the padding slots
when ``|S| < C``, so which client a padding slot names may differ from the
reference; valid slots, weights and every aggregate agree.

On a client axis split over S > 1 ranks the round body gathers the (N,)
mask and weights whole, so every rank makes the same selection from the
same priorities; each rank then trains its block of the C slots, and
``scatter_cohort(..., block=)`` writes the slots' values into the rank's
block of the (N,) axis.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.fed.tasks import tree_map

__all__ = [
    "CohortSelection",
    "select_cohort",
    "mask_selection",
    "scatter_cohort",
    "weighted_delta_sum",
    "host_gather_cohort_batches",
]


class CohortSelection(NamedTuple):
    """Static C-slot cohort (see module docstring)."""

    ids: torch.Tensor  # (C,) int64 client index per slot
    weights: torch.Tensor  # (C,) f32 estimator weight per slot (0 on padding)
    valid: torch.Tensor  # (C,) bool slot holds an included client
    n_included: torch.Tensor  # 0-d int |S| (pre-overflow)
    n_dropped: torch.Tensor  # 0-d int max(|S| - C, 0)


def select_cohort(
    mask: torch.Tensor, weights: torch.Tensor, cohort: int, priorities: torch.Tensor,
    shard=None,
) -> CohortSelection:
    """Map an (N,) inclusion mask + full weight vector onto C static slots,
    with (N,) uniform ``priorities`` deciding which clients an overflow
    drops.  With a ``shard`` that splits the client axis, ``mask`` and
    ``weights`` are this rank's blocks, gathered whole by one
    ``all_gather`` first, so every rank makes the same selection."""
    if shard is not None and shard.splits:
        n = priorities.shape[0]
        both = shard.gather(torch.stack([weights, mask.to(weights.dtype)], 1), n)
        weights, mask = both[:, 0], both[:, 1] > 0
    n = mask.shape[0]
    c = int(min(int(cohort), n))
    priority = torch.where(mask, priorities, -1.0)
    ids = torch.topk(priority, c).indices
    valid = mask[ids]
    n_inc = mask.to(torch.int32).sum()
    # rescale is exactly 1.0 without overflow (x * 1.0 is bitwise x), so the
    # cohort weights then equal the full-mask weights.
    rescale = torch.where(n_inc > c, n_inc.to(torch.float32) / c, 1.0)
    w = torch.where(valid, weights[ids].to(torch.float32) * rescale, 0.0)
    n_kept = valid.to(torch.int32).sum()
    return CohortSelection(
        ids=ids, weights=w, valid=valid, n_included=n_inc, n_dropped=n_inc - n_kept
    )


def mask_selection(
    sel: CohortSelection, keep: torch.Tensor, rescale: float = 1.0
) -> CohortSelection:
    """Demote slots with ``keep == False`` to inert padding after selection.

    The deadline-straggler hook (``core.stragglers``): late clients' training
    already ran, but their slot's weight and validity, and so their feedback
    and loss share, are zeroed like padding, leaving the (C, D) aggregation
    untouched.  Survivors' weights are multiplied by ``rescale`` (the
    ``1 / P(latency <= deadline)`` correction, cast to f32 as the reference
    does; 1.0 keeps them bitwise).  Newly dropped slots count in
    ``n_dropped``."""
    valid = sel.valid & keep
    w = torch.where(valid, sel.weights * float(np.float32(rescale)), 0.0)
    n_kept = valid.to(torch.int32).sum()
    return CohortSelection(
        ids=sel.ids, weights=w, valid=valid, n_included=sel.n_included,
        n_dropped=sel.n_included - n_kept,
    )


def scatter_cohort(values, sel: CohortSelection, n: int, block: tuple | None = None):
    """(C, ...)-stacked tensor or dict -> (N, ...) with zeros for clients
    outside the cohort.  Padding slots are zeroed first, so a padding slot
    cannot corrupt a real client's row; slot ids are distinct.  With
    ``block=(lo, hi)`` the result is rows ``lo .. hi - 1`` of that (N, ...)
    (a rank's block of a split client axis)."""
    valid, ids = sel.valid, sel.ids
    rows = n
    if block is not None:
        lo, hi = block
        inside = (ids >= lo) & (ids < hi)
        valid, ids, rows = valid & inside, torch.where(inside, ids - lo, 0), hi - lo

    def one(leaf):
        keep = valid.reshape((-1,) + (1,) * (leaf.dim() - 1))
        v = torch.where(keep, leaf, torch.zeros((), dtype=leaf.dtype, device=leaf.device))
        out = torch.zeros((rows,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)
        return out.index_add(0, ids, v)

    return tree_map(one, values)


def weighted_delta_sum(deltas, w: torch.Tensor):
    """``sum_c w_c * delta_c`` over a stacked (C, ...) dict, f32 accumulate."""

    def one(leaf):
        wc = w.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(torch.float32)
        return (wc * leaf.to(torch.float32)).sum(0)

    return tree_map(one, deltas)


def host_gather_cohort_batches(dataset, sel: CohortSelection, idx, local_steps: int,
                               batch_size: int):
    """Host-side padded batch gather: (C, R, B, ...) features and labels on
    the dataset's device, given ``idx``, the slots' (C, R, B) sample index
    rows.  Valid slots get their client's batches, one gather each; padding
    slots get zeros and cost no gather (their weight is zero, so the zeros
    never reach the estimate).  Reads the selection back to the host."""
    ids = sel.ids.cpu().tolist()
    valid = sel.valid.cpu().tolist()
    idx = torch.as_tensor(idx, device=dataset.device)
    feat_shape = (local_steps, batch_size) + tuple(dataset.features.shape[2:])
    lab_shape = (local_steps, batch_size) + tuple(dataset.labels.shape[2:])
    feats, labs = [], []
    for slot, (cid, ok) in enumerate(zip(ids, valid)):
        if not ok:
            feats.append(torch.zeros(feat_shape, dtype=dataset.features.dtype, device=dataset.device))
            labs.append(torch.zeros(lab_shape, dtype=dataset.labels.dtype, device=dataset.device))
            continue
        f, lab = dataset.client_batch(cid, idx[slot].reshape(-1))
        feats.append(f.reshape(feat_shape))
        labs.append(lab.reshape(lab_shape))
    return torch.stack(feats), torch.stack(labs)
