"""The zoo federated round: Algorithm 1 with a sampler over the zoo models.

Port of ``repro/fed/round.py``.  ``repro_torch.api.run`` with
``kind="zoo"`` projects the spec's ``FederationSpec`` onto a ``RoundSpec``
and drives ``build_fed_scan_segment`` through ``fed.state.run_segmented``.

Two cohort execution modes, picked by ``ArchConfig.round_mode``:

* ``client_parallel`` — the C cohort slots' local training runs under one
  ``torch.func.vmap``, so C diverged parameter copies live at once;
* ``cohort_sequential`` — a loop over the slots, one diverged copy at a
  time, each delta added into an f32 accumulator (the big configs).

Both produce the new parameters ``x - server_lr * d`` with the unbiased
estimate ``d = sum_c w_c (x - x_c^R)`` (w_c = 0 on padding slots), each
slot's update norm (the sampler's feedback before the lambda weights), and
the mean loss over the slots with ``w != 0``.

The round consumes a static padded cohort of C slots (``fed.cohort``): the
draw's inclusion mask is folded into the weights, and padding slots train on
zero tokens and count for nothing.  Every draw comes from the run's random
source (``repro_torch.rng``): the sampler's draw input, the cohort
priorities, the fault layer's variates and the (N, R, B) batch indices, of
which the cohort's rows are gathered.  A parity test replays the reference's
own draws along its key chain.

Over a client axis split across S > 1 ranks (the sampler's ``ShardSpec``;
``api.run`` with ``execution.mesh_shape=(S, 1)``), every rank holds its
block of the sampler state and makes the same selection from the gathered
mask and weights, as ``fed.server`` does.  ``client_parallel``: each rank
trains its block of the C slots; the weighted partial sum (kernel 2, or
kernel 4 with compression) is ``all_reduce``d and the slots' norms and
losses are ``all_gather``ed.  ``cohort_sequential``: every rank runs every
slot on its block of each local batch's B rows, as the reference splits the
batch over its data axes; each local step ``all_reduce``s the gradient of
the rows' summed loss and divides by B, so the diverged copy stays the same
on every rank and an uneven split is exact.  The step runs inside
``models.sharding.split_rows`` over the shards' line: a MoE arch's dense
dispatch, whose capacity, slots and load-balance loss couple a batch's
rows, computes them over the whole batch (``models/moe.py``).

Under ``models.sharding.use_rules`` over a mesh with more than one rank
(the dry run's count of one chip, a per-rank step), the parameters are this
rank's blocks (``launch/sharding.py``), the model code runs its share, and
each slot's update norm sums every element once: a leaf's local squared
norm is all_reduced over the axes its spec splits it over, a leaf whole
on every rank counts once (``split_update_norm``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import estimator, stragglers
from repro_torch.core.samplers import draw_input
from repro_torch.fed import client as fed_client
from repro_torch.fed.cohort import mask_selection, scatter_cohort, select_cohort, weighted_delta_sum
from repro_torch.fed.state import TrainState, init_metric_buffers, make_segment_fn
from repro_torch.fed.state import StateLayout
from repro_torch.fed.tasks import tree_leaves, tree_map
from repro_torch.launch.mesh import ShardSpec
from repro_torch.models import sharding as msh
from repro_torch.models import transformer
from repro_torch.models.common import ArchConfig

__all__ = [
    "RoundSpec", "ZooModel", "build_round_step", "build_fed_scan", "build_fed_scan_segment",
    "scan_body_for_lint",
]


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """The reference's ``RoundSpec`` field for field (see its comments)."""

    cohort: int  # padded cohort size C
    local_steps: int  # R
    local_lr: float = 0.02
    server_lr: float = 1.0
    local_batch: int = 2  # B, each client's local batch
    faults: object | None = None  # an api.FaultSpec (enabled) or None
    # An api.CompressionSpec or None; client_parallel only.
    compression: object | None = None


@dataclasses.dataclass(frozen=True)
class ZooModel:
    """A zoo architecture as a random source's ``init_params`` sees a task:
    ``init`` draws fresh weights, ``params_from_reference`` takes the JAX
    reference's tree (a replayed source's recorded weights)."""

    cfg: ArchConfig

    def init(self, gen: torch.Generator, device) -> dict:
        return transformer.init_params(self.cfg, gen, device)

    def params_from_reference(self, tree, device) -> dict:
        return transformer.params_from_reference(tree, self.cfg, device)


def _cohort_mean_loss(losses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mean loss over the slots with ``w != 0``: padding slots train on zero
    tokens, and their loss must not reach the round's."""
    active = weights != 0.0
    n = torch.clamp(active.to(torch.float32).sum(), min=1.0)
    return torch.where(active, losses, 0.0).sum() / n


def _server_step(params, d, server_lr: float):
    """``p - server_lr * d``, the f32 estimate cast to each leaf's dtype."""
    return tree_map(lambda p, g: p - server_lr * g.to(p.dtype), params, d)


def _batch(tokens, targets, aux_embeds) -> tuple:
    """The round's per-slot batch tuple: aux_embeds joins only when given."""
    return (tokens, targets) if aux_embeds is None else (tokens, targets, aux_embeds)


def _spec_leaves(specs) -> list:
    """The specs of a tree in ``tree_leaves``' order (a spec is a tuple)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def split_update_norm(delta, specs) -> torch.Tensor:
    """``fed.client.update_norm`` of a tree of this rank's blocks laid out
    by ``specs``: the leaves' f32 squared sums, grouped by the mesh axes
    their specs split, each group's partial all_reduced over those axes."""
    from repro_torch.launch.sharding import spec_axes

    parts: dict = {}
    for leaf, spec in zip(tree_leaves(delta), _spec_leaves(specs)):
        axes = tuple(sorted({a for e in spec for a in spec_axes(e)}))
        sq = leaf.float().square().sum()
        parts[axes] = sq if axes not in parts else parts[axes] + sq
    total = None
    for axes, sq in parts.items():
        sq = msh.all_reduce(sq, msh.group_of(axes)) if axes else sq
        total = sq if total is None else total + sq
    return total.sqrt()


def _split_local_update(params, loss, batches, local_lr: float, rows: int, shard):
    """``fed.client.local_update`` on this rank's ``b`` of ``rows`` batch
    rows: each step's gradient and loss are scaled by ``b``, summed over the
    shards and divided by ``rows`` (the gradient of the global mean loss),
    so every rank takes the same step.  One ``all_reduce`` a leaf, in place
    at the gradient's own dtype, and one for the loss."""
    grad_fn = torch.func.grad_and_value(loss)
    b = batches[0].shape[1]
    p = params
    last = None
    for r in range(batches[0].shape[0]):
        grads, last = grad_fn(p, tuple(x[r] for x in batches))
        for g in tree_leaves(grads):  # in place: no second copy of the gradients
            red = shard.sum(g.mul_(b)).div_(rows)
            if red is not g:  # a strided gradient was reduced in a contiguous copy
                g.copy_(red)
        last = shard.sum(last * b) / rows
        p = tree_map(lambda w, g: w - local_lr * g, p, grads)
        del grads
    return tree_map(lambda a, c: a - c, params, p), last


def build_round_step(cfg: ArchConfig, spec: RoundSpec, constrain=None, shard=None) -> Callable:
    """``round_step(params, tokens, targets, weights, aux_embeds=None,
    resid=None)`` -> ``(new_params, norms (C,) f32, loss, [new_resid])``.

    tokens / targets: (C, R, B, S) integer, each slot's R local batches;
    aux_embeds (the frontend archs): (C, R, B, S_front, F), each step's
    frontend embeddings; weights: (C,) f32 (zero on padding).  Each client runs R local SGD steps
    (``fed.client.local_update``: ``w - lr * g`` in the parameter dtype, the
    delta ``x0 - xR`` in the parameter dtype, the last step's loss) and
    reports ``fed.client.update_norm`` of its delta.  With
    ``spec.compression`` (client_parallel only) the stacked deltas are
    aggregated by ``core.estimator.aggregate_compressed`` (kernel 4) with
    ``weights`` as the lambda row, the dequantized norms are the feedback,
    and ``resid`` / ``new_resid`` carry the error feedback (None without).
    ``constrain`` (the reference's sharding hook) is accepted and unused.

    With a ``shard`` that splits the client axis over S > 1 ranks (module
    docstring): ``client_parallel`` takes this rank's block of the slots
    (tokens, targets, weights) and returns every slot's norms; a
    ``cohort_sequential`` step takes every slot's block of the B rows."""
    del constrain
    mode = cfg.round_mode
    comp = spec.compression
    split = shard is not None and shard.splits
    if comp is not None and mode != "client_parallel":
        raise ValueError(
            f"RoundSpec.compression needs round_mode='client_parallel' (got "
            f"{mode!r}): cohort_sequential accumulates per-member deltas one "
            "at a time and never materializes the (C, D) stacked buffer that "
            "delta-width compression shrinks"
        )

    def loss(params, batch):
        return transformer.loss_fn(params, cfg, batch)

    def norm(delta):
        specs = transformer._specs(cfg)
        return fed_client.update_norm(delta) if specs is None else split_update_norm(delta, specs)

    def per_client(params, *batches):
        delta, last = fed_client.local_update(params, loss, batches, spec.local_lr)
        return delta, last, norm(delta)

    if mode == "client_parallel":

        def round_step(params, tokens, targets, weights, aux_embeds=None, resid=None):
            data = _batch(tokens, targets, aux_embeds)
            clients = torch.func.vmap(per_client, in_dims=(None,) + (0,) * len(data))
            deltas, losses, norms = clients(params, *data)
            if split:
                if comp is None:
                    d, out = estimator.aggregate_cohort(deltas, weights, shard=shard), ()
                else:
                    d, _, norms, new_resid = estimator.aggregate_compressed(
                        deltas, weights, weights, comp, resid, shard=shard
                    )
                    out = (new_resid,)
                every = shard.gather(torch.stack([losses, norms, weights], 1), spec.cohort)
                return (_server_step(params, d, spec.server_lr), every[:, 1],
                        _cohort_mean_loss(every[:, 0], every[:, 2])) + out
            mean_loss = _cohort_mean_loss(losses, weights)
            if comp is None:
                if transformer._specs(cfg) is None:
                    d = weighted_delta_sum(deltas, weights)
                else:  # under a mesh: kernel 2 on the (C, D) flatten of this rank's blocks
                    d = estimator.aggregate_cohort(deltas, weights, shard=ShardSpec())
                return _server_step(params, d, spec.server_lr), norms, mean_loss
            d, _, norms, new_resid = estimator.aggregate_compressed(
                deltas, weights, weights, comp, resid
            )
            return _server_step(params, d, spec.server_lr), norms, mean_loss, new_resid

        return round_step

    if mode == "cohort_sequential":

        def round_step(params, tokens, targets, weights, aux_embeds=None, resid=None):
            del resid  # no compression in this mode
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                           params)
            losses, norms = [], []
            data = _batch(tokens, targets, aux_embeds)
            for c in range(tokens.shape[0]):
                if split:
                    with msh.split_rows(shard.axis_group(), spec.local_batch):
                        delta, last = _split_local_update(
                            params, loss, tuple(a[c] for a in data), spec.local_lr,
                            spec.local_batch, shard,
                        )
                    norm = fed_client.update_norm(delta)
                else:
                    delta, last, norm = per_client(params, *(a[c] for a in data))
                w = weights[c]
                for a, dl in zip(tree_leaves(acc), tree_leaves(delta)):
                    a.add_(w * dl.to(torch.float32))  # in place: one f32 accumulator
                del delta  # one diverged copy at a time
                losses.append(last)
                norms.append(norm)
            losses, norms = torch.stack(losses), torch.stack(norms)
            return (_server_step(params, acc, spec.server_lr), norms,
                    _cohort_mean_loss(losses, weights))

        return round_step

    raise ValueError(f"unknown round_mode {mode!r}")


def _metric_shapes(spec: RoundSpec) -> dict:
    """Every per-round metric of the round body, before round 0: name ->
    ``(shape, dtype)`` (``fed.state.init_metric_buffers``)."""
    i64 = torch.int64
    shapes = {"loss": ((), torch.float32), "cohort_size": ((), i64), "dropped": ((), i64)}
    if spec.faults is not None and spec.faults.deadline is not None:
        shapes["deadline_dropped"] = ((), i64)
    return shapes


def _build_body(cfg: ArchConfig, spec: RoundSpec, sampler, dataset, source):
    """One round: ``(t, carry) -> (new carry, metrics)`` with the carry
    ``(params, (), sampler_state)``, then the fault state with
    ``spec.faults``, then ``{"resid": (D,) f32}`` with error feedback."""
    lam = dataset.lam
    n = dataset.n_clients
    device = dataset.device
    c_slots = int(spec.cohort)
    # A split client axis (module docstring): this rank's block of the
    # clients, and of the slots or of each batch's rows.
    shard = sampler.shard if sampler.splits else None
    round_step = build_round_step(cfg, spec, shard=shard)
    block, lam_b, slots, rows = None, lam, slice(None), slice(None)
    if shard is not None:
        _check_split(shard, cfg, spec, n)
        block = shard.block(n)
        lam_b = lam[block[0]:block[1]]
        if cfg.round_mode == "client_parallel":
            slots = slice(*shard.block(c_slots))
        else:
            rows = slice(*shard.block(spec.local_batch))
    fault = spec.faults
    fault_on = fault is not None
    avail_on = fault_on and fault.availability is not None
    deadline_on = fault_on and fault.deadline is not None
    async_on = fault_on and int(fault.async_buffer) > 0
    comp = spec.compression
    ef_on = comp is not None and bool(comp.error_feedback)
    if deadline_on:
        surv = stragglers.deadline_survival(fault)
        deadline = float(np.float32(fault.deadline))

    def gather_cohort(sel, t):
        """(C, R, B, S) tokens and targets of the cohort's slots: rows
        ``idx[sel.ids]`` of the round's (N, R, B) batch indices; padding
        slots are zeroed.  On a split client axis: this rank's slots, or
        this rank's rows of every slot."""
        idx = source.batch_indices(t, dataset.sizes, spec.local_steps, spec.local_batch)
        ids = sel.ids[slots]
        tokens, targets = dataset.gather(ids, idx[ids][:, :, rows])
        keep = sel.valid[slots].reshape(-1, 1, 1, 1)
        return (torch.where(keep, tokens, 0).long(), torch.where(keep, targets, 0).long())

    def body(t: int, carry):
        c_state = {}
        if ef_on:
            carry, c_state = carry[:-1], carry[-1]
        if fault_on:
            params, opt_state, s_state, f_state = carry
        else:
            params, opt_state, s_state = carry
        p = sampler.probabilities(s_state)
        draw = sampler.sample_from(p, draw_input(source, sampler.procedure, t, n, sampler.budget))
        if avail_on:
            diurnal = fault.availability == "diurnal"  # a schedule: no draw
            u_avail = None if diurnal else sampler.shard_constrain(
                source.availability_uniforms(t, n))
            avail_mask, q_t, new_chain = stragglers.availability_step(
                fault, f_state.get("chain"), t, u_avail, n, device, block
            )
            draw = stragglers.available_draw(draw, avail_mask, q_t)
            if "chain" in f_state:
                f_state = {**f_state, "chain": new_chain}
        w_full = estimator.client_weights(draw, lam_b, sampler.procedure, sampler.budget)
        sel = select_cohort(draw.mask, w_full, c_slots, source.cohort_priorities(t, n), shard)
        metrics = {"dropped": sel.n_dropped}  # overflow drops, before the deadline's
        if deadline_on:
            # Every slot still trains (the server scheduled it); late slots
            # become inert padding, survivors are reweighted by 1 / surv.
            lat_c = stragglers.latency_draw(fault, source.latencies(t, (c_slots,), fault.latency))
            late_c = sel.valid & (lat_c > deadline)
            sel = mask_selection(sel, ~late_c, 1.0 / surv)
            metrics["deadline_dropped"] = late_c.to(torch.int32).sum()
        tokens, targets = gather_cohort(sel, t)
        if comp is not None:
            new_params, norms, loss, new_resid = round_step(
                params, tokens, targets, sel.weights[slots], resid=c_state.get("resid")
            )
            if ef_on:
                c_state = {"resid": new_resid}
        else:
            new_params, norms, loss = round_step(params, tokens, targets, sel.weights[slots])
        if async_on:
            # The round step applied x - server_lr * d: recover the update,
            # route it through the stale-delta ring, apply what arrived.
            u = tree_map(lambda a, b: a - b, params, new_params)
            new_buf, apply_vec, _ = stragglers.async_step(
                fault, f_state["buf"], stragglers.tree_to_vec(u), t,
                source.async_latency(t, fault.latency), comp,
            )
            f_state = {**f_state, "buf": new_buf}
            d_apply = stragglers.vec_to_tree(apply_vec, params)
            params = tree_map(lambda a, g: a - g, params, d_apply)
        else:
            params = new_params
        # The sampler's (N,) feedback: lambda * norm at the valid slots.
        s_state = sampler.update(
            s_state, draw, scatter_cohort(lam[sel.ids] * norms, sel, n, block))
        metrics["loss"] = loss
        metrics["cohort_size"] = sel.valid.to(torch.int32).sum()
        out = (params, opt_state, s_state)
        if fault_on:
            out = out + (f_state,)
        if ef_on:
            out = out + (c_state,)
        return out, metrics

    return body


def _check_split(shard, cfg: ArchConfig, spec: RoundSpec, n: int) -> None:
    """Every rank must hold at least one client, and one slot
    (``client_parallel``) or one row of each batch (``cohort_sequential``)."""
    s = shard.num_shards
    width, what = ((spec.cohort, "cohort slots") if cfg.round_mode == "client_parallel"
                   else (spec.local_batch, "local batch rows"))
    if n < s or width < s:
        raise ValueError(
            f"the client axis is split over {s} ranks, but the round has {n} clients and "
            f"{width} {what}: each rank needs at least one of each"
        )


def _template(cfg: ArchConfig, spec: RoundSpec, sampler, n: int, shapes: dict) -> TrainState:
    """The round-0 ``TrainState``'s (N,)-bearing fields as ``meta`` tensors
    (the ``StateLayout`` template of a split run; the fields
    ``build_placement`` replicates whole are None)."""
    faults = ()
    if spec.faults is not None:
        d_dim = stragglers.flat_dim(transformer.init_params(cfg, None, "meta"))
        faults = stragglers.abstract_fault_state(spec.faults, n, d_dim, spec.compression)
    return TrainState(params=None, opt_state=None, sampler=sampler.init("meta"),
                      metrics=init_metric_buffers(shapes, 1, "meta"), round=0, source=None,
                      faults=faults, compression=None)


def scan_body_for_lint(cfg: ArchConfig, spec: RoundSpec, sampler, dataset, *, source=None):
    """Lintable handle on the zoo round body: ``(body, (carry, t))``.

    ``body(t, carry)`` is the round ``build_fed_scan_segment`` runs, built
    on the CPU over ``dataset`` (moved there) and ``source`` (default a
    CPU ``PhiloxSource``; its draws are traced as graph nodes); ``carry``
    is round 0's carry as
    ``meta`` tensors: the parameters from ``transformer.init_params`` on
    ``meta`` (shapes and dtypes only: no weights are made), the sampler's
    ``init("meta")``, the fault and error-feedback states; ``t`` round 0.
    ``repro_torch.analysis.lint`` traces ``body`` on fake tensors of the
    carry's shapes."""
    from repro_torch.fed.server import _to_meta
    from repro_torch.rng import PhiloxSource

    dataset = dataset.to("cpu")
    source = PhiloxSource(0, "cpu") if source is None else source
    body = _build_body(cfg, spec, sampler, dataset, source)
    params = transformer.init_params(cfg, None, "meta")
    carry = (params, (), sampler.init("meta"))
    d_dim = stragglers.flat_dim(params)
    if spec.faults is not None:
        carry = carry + (_to_meta(stragglers.fault_state_init(
            spec.faults, dataset.n_clients, d_dim, spec.compression, "cpu")),)
    if spec.compression is not None and bool(spec.compression.error_feedback):
        carry = carry + ({"resid": torch.empty(d_dim, dtype=torch.float32, device="meta")},)
    return body, (carry, 0)


def build_fed_scan_segment(cfg: ArchConfig, spec: RoundSpec, sampler, dataset, *, source,
                           device=None):
    """``(segment_fn, make_state)`` of the zoo round on ``dataset``'s device.

    * ``make_state(params, s_state, total_rounds)`` is the round-0
      ``TrainState``: the parameters and sampler state, ``opt_state = ()``
      (the server update is stateless), zero metric buffers for the whole
      horizon (``loss``, ``cohort_size``, ``dropped``, and with a deadline
      ``deadline_dropped``), the source's state, and the fault and
      error-feedback carries.  It is also the restore template of
      ``CheckpointManager.restore_or_init``.
    * ``segment_fn(state, n_rounds)`` runs rounds ``state.round ..
      state.round + n_rounds - 1`` (``fed.state.make_segment_fn``), bitwise
      the same for any segmentation."""
    dev = dataset.device if device is None else torch.device(device)
    if dataset.device != dev:
        raise ValueError(f"the dataset is on {dataset.device}, the run on {dev}")
    fault_on = spec.faults is not None
    ef_on = spec.compression is not None and bool(spec.compression.error_feedback)
    body = _build_body(cfg, spec, sampler, dataset, source)
    shapes = _metric_shapes(spec)

    def make_state(params, s_state, total_rounds: int) -> TrainState:
        d_dim = stragglers.flat_dim(params)
        faults = (
            stragglers.fault_state_init(spec.faults, dataset.n_clients, d_dim, spec.compression, dev)
            if fault_on else ()
        )
        comp = {"resid": torch.zeros(d_dim, dtype=torch.float32, device=dev)} if ef_on else ()
        return TrainState(
            params=params,
            opt_state=(),
            sampler=s_state,
            metrics=init_metric_buffers(shapes, total_rounds, dev),
            round=0,
            source=source.state_dict(),
            faults=faults,
            compression=comp,
        )

    layout = None
    if sampler.splits:
        layout = StateLayout(_template(cfg, spec, sampler, dataset.n_clients, shapes), sampler)
    segment = make_segment_fn(
        body, source, with_faults=fault_on, with_compression=ef_on, layout=layout)
    return segment, make_state


def build_fed_scan(cfg: ArchConfig, spec: RoundSpec, sampler, dataset, *, source, device=None):
    """The whole horizon as one segment: ``run(params, s_state, rounds)`` ->
    ``(params, s_state, metrics)``, metrics the (T,) ``loss`` /
    ``cohort_size`` / ``dropped`` buffers.  Faults and compression carry
    state across segments, so they need ``build_fed_scan_segment``."""
    if spec.faults is not None:
        raise ValueError(
            "RoundSpec.faults requires the segment-shaped runner "
            "(build_fed_scan_segment): the fault state (availability chain, "
            "stale-delta buffer) lives in the TrainState carry, which the "
            "monolithic build_fed_scan signature cannot thread"
        )
    if spec.compression is not None:
        raise ValueError(
            "RoundSpec.compression requires the segment-shaped runner "
            "(build_fed_scan_segment): the error-feedback residual lives in "
            "the TrainState carry, which the monolithic build_fed_scan "
            "signature cannot thread"
        )
    segment, make_state = build_fed_scan_segment(
        cfg, spec, sampler, dataset, source=source, device=device
    )

    def run(params, s_state, rounds: int):
        state = segment(make_state(params, s_state, rounds), rounds)
        return state.params, state.sampler, state.metrics

    return run
