"""Federated server loop (Algorithm 1) at simulation scale.

Port of ``repro/fed/server.py``.  ``repro_torch.api.run(spec)`` builds the
``(task, dataset, sampler, FedConfig)`` tuple and calls ``run_federated``.

Each round (``_build_round_body``):

1. the sampler solves its marginals (K-Vib: water-filling + mixing), or
   for an RSP sampler its per-draw distribution;
2. the sampler's draw picks the clients (an independent Bernoulli draw for
   ISP, K draws for RSP), its input taken by procedure from the run's
   random source (``repro_torch.rng``, ``core.samplers.draw_input``);
3. ``estimator.client_weights`` forms the estimator weights;
4. clients run local SGD, vmapped (``torch.func.vmap``) over all N clients
   in oracle mode or over the C cohort slots in deployable mode;
5. the deltas are aggregated with the estimator's squared error by one of
   the CUDA kernels (``fused_multi_weighted_agg`` in oracle mode,
   ``fused_cohort_agg_and_error`` in deployable mode), or, with
   ``cfg.compression`` set, quantized to int8 or fp8 and aggregated by
   ``fused_dequant_cohort_agg`` in either mode, whose dequantized norms then
   replace the clients' update norms as the sampler's feedback;
6. the server optimizer applies the estimate;
7. the sampler updates and, in oracle mode, ``regret.round_costs`` records
   the round's online costs at the draw's inclusion probabilities (RSP:
   ``K * draw_probs`` clipped to (0, 1], as the reference approximates them).

Per-round metrics stay on the device in (T,)-preallocated buffers and reach
the host once, at the end.  ``compiled=False`` runs the same body but copies
each round's metrics to the host as it ends (the debuggable loop of the
reference); the two give identical results.

Metric fidelities, as in the reference:

* ``oracle_metrics=True``: every client trains every round, so the paper's
  diagnostics (dynamic regret, estimator squared error) are exact.
* ``oracle_metrics=False`` (deployable): only a static C-slot cohort
  (``FedConfig.cohort``, default ``min(2K, N)``) trains, selected from the
  draw by ``fed.cohort.select_cohort``; aggregation is C-width.

``cfg.faults`` (a ``FaultSpec``) switches on the fault layer
(``core.stragglers``), in the reference's order: the availability process
intersects the draw (composed ``q * p`` correction) right after step 2;
deadline stragglers are dropped after local training, with survivors
reweighted by ``1 / P(latency <= deadline)`` (``fed.cohort.mask_selection``
in deployable mode); and buffered async routes step 6 through the carried
stale-delta ring, whose pending deltas flush once after the last round.

The carry is ``(params, opt_state, sampler_state)``, then the fault state
(a dict: the Markov ``chain``, the async ``buf``) when ``cfg.faults`` is set,
then with error feedback the (D,) f32 residual ``{"resid": ...}``, zero at
round 0, as the reference's ``TrainState`` orders them.

The compiled path (``compiled=True``) runs through ``fed.state``: the
round-0 ``TrainState`` (``build_segment_runner``) advances in segments of
``cfg.ckpt_every`` rounds (``run_segmented``), bitwise the same for any
segmentation; with a ``repro_torch.checkpoint.CheckpointManager`` the run
restores the latest committed state first and publishes one at every
boundary, so a preempted run re-invoked with the same config and manager
gives the uninterrupted run's ``History``.  The async ring flushes at the
end of the horizon only.  ``exact_oracle_equiv`` (deployable mode)
scatters the cohort's deltas and weights back to N rows and aggregates
them with the oracle contraction (kernel 1 at (2, N) x (N, D)), bitwise the
oracle run at C = N; ``score_history_host_offload`` keeps a device ring of
``ckpt_every`` score rows, drained to the host at each boundary.

When the sampler's ``ShardSpec`` splits the client axis over S > 1 ranks
(``api.run`` over a mesh whose data axes hold S ranks), every rank runs the
round on its block of it, as the reference splits it over the mesh's data
axes: the sampler state, the draw, the Markov chain and the score history
are blocks (``fed.state.StateLayout``); in oracle mode a rank trains only
its block of the N clients, in deployable mode its block of the C slots of
a selection every rank makes alike from the gathered mask and weights.
The aggregates, the loss and the counts are ``all_reduce``d, so the
parameters, the optimizer state, the residual and the async ring stay
replicated, and every rank returns the same ``History``.  Every rank draws
the global inputs from the same random source and keeps its block.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import estimator, regret, stragglers
from repro_torch.core.regret import RegretTracker
from repro_torch.core.samplers import Sampler, draw_input
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.fed import client as fed_client
from repro_torch.fed import cohort as fed_cohort
from repro_torch.fed.state import (
    StateLayout,
    TrainState,
    init_metric_buffers,
    make_segment_fn,
    run_segmented,
)
from repro_torch.fed.tasks import Task, params_to_numpy
from repro_torch.optim.fedopt import FedAvgServer, ServerOptimizer
from repro_torch.rng import PhiloxSource, RandomSource

__all__ = [
    "FedConfig", "History", "init_carry", "build_segment_runner", "run_federated",
    "round_body_for_lint",
]


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """The reference's ``FedConfig`` field for field (see its comments)."""

    rounds: int = 100
    budget: int = 10
    local_steps: int = 1
    batch_size: int = 64
    local_lr: float = 0.02
    server_opt: ServerOptimizer = FedAvgServer(lr=1.0)
    seed: int = 0
    eval_every: int = 5
    eval_batches: int = 4
    oracle_metrics: bool = True
    compiled: bool = True  # False: per-round host copies of the metrics
    # Deployable-mode static cohort buffer size C; None -> min(2 * budget, N).
    cohort: int | None = None
    exact_oracle_equiv: bool = False  # deployable: N-width scatter + oracle contraction
    track_scores: bool = True  # oracle-mode (T, N) score history
    score_history_bytes_limit: int = 1 << 30
    score_history_host_offload: bool = False  # (ckpt_every, N) device ring, drained
    ckpt_every: int = 0  # bitwise-neutral segmentation; a manager saves at each boundary
    faults: object | None = None  # an api.FaultSpec (enabled) or None
    # An api.CompressionSpec (int8/fp8 deltas, error feedback) or None.
    compression: object | None = None

    def cohort_slots(self, n_clients: int) -> int:
        c = 2 * self.budget if self.cohort is None else int(self.cohort)
        return max(1, min(c, n_clients))


@dataclasses.dataclass
class History:
    rounds: list = dataclasses.field(default_factory=list)
    train_loss: list = dataclasses.field(default_factory=list)
    test_accuracy: list = dataclasses.field(default_factory=list)
    estimator_sq_error: list = dataclasses.field(default_factory=list)
    cohort_size: list = dataclasses.field(default_factory=list)
    cohort_dropped: list = dataclasses.field(default_factory=list)  # deployable
    deadline_dropped: list = dataclasses.field(default_factory=list)  # fault layer
    regret: RegretTracker | None = None
    wall_time_s: float = 0.0
    final_params: object = None  # trained parameters, nested dicts of numpy arrays

    def summary(self) -> dict:
        out = {
            "final_loss": self.train_loss[-1] if self.train_loss else None,
            "final_acc": self.test_accuracy[-1] if self.test_accuracy else None,
            "mean_sq_error": float(np.mean(self.estimator_sq_error))
            if self.estimator_sq_error
            else None,
            "mean_cohort": float(np.mean(self.cohort_size)) if self.cohort_size else None,
            "wall_time_s": self.wall_time_s,
        }
        if self.regret is not None and self.regret.costs:
            out["final_dynamic_regret_per_round"] = float(
                self.regret.dynamic_regret()[-1] / len(self.regret.costs)
            )
        return out


def _score_history_plan(cfg: FedConfig, n_clients: int):
    """Rows of the oracle (T, N) score-history buffer on the device, or None
    without one: ``cfg.rounds``, or ``ckpt_every`` with host offload (a ring
    drained at each segment boundary).  Raises instead of allocating a
    full-horizon buffer over ``cfg.score_history_bytes_limit``."""
    if not (cfg.oracle_metrics and cfg.track_scores):
        return None
    full_bytes = int(cfg.rounds) * int(n_clients) * 4
    if cfg.score_history_host_offload:
        if cfg.ckpt_every <= 0:
            raise ValueError(
                "score_history_host_offload=True needs ckpt_every > 0 (the "
                "device ring holds one segment of score rows); got "
                f"ckpt_every={cfg.ckpt_every}"
            )
        return min(int(cfg.ckpt_every), int(cfg.rounds))
    if full_bytes > cfg.score_history_bytes_limit:
        raise ValueError(
            f"track_scores=True would allocate a ({cfg.rounds}, {n_clients}) f32 "
            f"score-history buffer ({full_bytes / 2**20:.0f} MiB) on the device, "
            f"over score_history_bytes_limit={cfg.score_history_bytes_limit / 2**20:.0f} "
            "MiB.  Set score_history_host_offload=True (chunked host drain), raise "
            "the limit, or set track_scores=False."
        )
    return int(cfg.rounds)


def _build_clients(task: Task, cfg: FedConfig):
    """Local training of a stack of clients: (params, xs (C, R, B, ...),
    ys (C, R, B)) -> (deltas (C, ...), losses (C,), update norms (C,)).
    One definition for both modes, so their per-client numerics match."""

    def one_client(params, xs, ys):
        delta, loss = fed_client.local_update(params, task.loss, (xs, ys), cfg.local_lr)
        return delta, loss, fed_client.update_norm(delta)

    return torch.func.vmap(one_client, in_dims=(None, 0, 0))


def _build_round_body(
    task: Task,
    dataset: FederatedDataset,
    sampler: Sampler,
    cfg: FedConfig,
    eval_data,
    source: RandomSource,
):
    """One federated round: ``(t, carry) -> (new carry, per-round metrics)``,
    every metric a tensor on the device.  The carry is ``(params, opt_state,
    sampler_state)``, plus the fault state with ``cfg.faults`` and
    ``{"resid": (D,) f32}`` with error feedback (module docstring)."""
    lam = dataset.lam
    n = dataset.n_clients
    device = dataset.device
    all_ids = torch.arange(n, device=device)
    clients = _build_clients(task, cfg)
    c_slots = cfg.cohort_slots(n)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=device)
    comp = cfg.compression
    ef_on = comp is not None and bool(comp.error_feedback)
    fault = cfg.faults
    fault_on = fault is not None
    avail_on = fault_on and fault.availability is not None
    deadline_on = fault_on and fault.deadline is not None
    async_on = fault_on and int(fault.async_buffer) > 0
    if deadline_on:
        # Build-time survival probability (raises if the deadline is
        # unsatisfiable); survivors' weights are divided by it.
        surv = stragglers.deadline_survival(fault)
        deadline = float(np.float32(fault.deadline))
    # A split client axis (module docstring): this rank's block of the N
    # clients and of the C slots; one shard keeps the whole of both.
    shard = sampler.shard if sampler.splits else None
    block, lam_b, ids_b, slots = None, lam, all_ids, slice(None)
    if shard is not None:
        width = n if cfg.oracle_metrics else c_slots
        if width < shard.num_shards:
            raise ValueError(
                f"the client axis is split over {shard.num_shards} ranks, but the round trains "
                f"{width} {'clients' if cfg.oracle_metrics else 'cohort slots'}: each rank "
                "needs at least one"
            )
        block = shard.block(n)
        lam_b, ids_b = lam[block[0]:block[1]], all_ids[block[0]:block[1]]
        slots = slice(*shard.block(c_slots))

    def gsum(x):
        return x if shard is None else shard.sum(x)

    def body(t: int, carry):
        c_state = {}
        if ef_on:
            carry, c_state = carry[:-1], carry[-1]
        if fault_on:
            params, opt_state, s_state, f_state = carry
        else:
            params, opt_state, s_state = carry
        # Solve p~ once; reuse it for the draw AND the regret diagnostics.
        p_marg = sampler.probabilities(s_state)
        draw = sampler.sample_from(
            p_marg, draw_input(source, sampler.procedure, t, n, sampler.budget)
        )
        if avail_on:
            # Composing q into the draw's probabilities makes the plain
            # client_weights below the availability-corrected 1/(q p) weights.
            diurnal = fault.availability == "diurnal"  # a schedule: no draw
            u_avail = None if diurnal else sampler.shard_constrain(
                source.availability_uniforms(t, n))
            avail_mask, q_t, new_chain = stragglers.availability_step(
                fault, f_state.get("chain"), t, u_avail, n, device, block
            )
            draw = stragglers.available_draw(draw, avail_mask, q_t)
            if "chain" in f_state:
                f_state = {**f_state, "chain": new_chain}
        weights = estimator.client_weights(draw, lam_b, sampler.procedure, sampler.budget)
        idx = source.batch_indices(t, dataset.sizes, cfg.local_steps, cfg.batch_size)

        metrics = {}
        if cfg.oracle_metrics:
            idx_b = idx if shard is None else idx[block[0]:block[1]]
            deltas, losses, norms = clients(params, *dataset.gather(ids_b, idx_b))
            active = draw.mask
            if deadline_on:
                # Clients past the deadline report nothing; survivors / surv
                # keeps the estimate unbiased.
                lat = stragglers.latency_draw(fault, sampler.shard_constrain(
                    source.latencies(t, (n,), fault.latency)))
                late = draw.mask & (lat > deadline)
                active = draw.mask & ~late
                weights = torch.where(late, 0.0, weights * float(np.float32(1.0 / surv)))
                metrics["deadline_dropped"] = gsum(late.to(torch.int32).sum())
            metrics["train_loss"] = gsum((lam_b * losses).sum())
            metrics["cohort_size"] = gsum(
                active.to(torch.int32).sum() if deadline_on else draw.size)
            if comp is not None:
                # The feedback norms are the dequantized ones: the regret
                # signal is what the estimator saw.
                d_est, sq_err, norms, new_resid = estimator.aggregate_compressed(
                    deltas, weights, lam_b, comp, c_state.get("resid"), shard=shard
                )
            else:
                d_est, sq_err = estimator.aggregate_and_error(deltas, weights, lam_b, shard=shard)
            feedback_full = lam_b * norms  # pi_t(i) = lambda_i ||g_i||
            feedback = feedback_full * active
        else:
            sel = fed_cohort.select_cohort(
                draw.mask, weights, c_slots, source.cohort_priorities(t, n), shard
            )
            metrics["dropped"] = sel.n_dropped  # overflow drops, before the deadline's
            ids_c = sel.ids[slots]
            deltas_c, losses_c, norms_c = clients(
                params, *dataset.gather(ids_c, idx[ids_c])
            )
            if deadline_on:
                # Late slots become inert padding after their training ran.
                lat_c = stragglers.latency_draw(
                    fault, source.latencies(t, (c_slots,), fault.latency)
                )
                late_c = sel.valid & (lat_c > deadline)
                sel = fed_cohort.mask_selection(sel, ~late_c, 1.0 / surv)
                metrics["deadline_dropped"] = late_c.to(torch.int32).sum()
            lam_c = torch.where(sel.valid, lam[sel.ids], 0.0)
            valid_l, w_l, lam_l = sel.valid[slots], sel.weights[slots], lam_c[slots]
            # Unbiased cohort estimate of the full weighted loss.
            metrics["train_loss"] = gsum(torch.where(valid_l, w_l * losses_c, 0.0).sum())
            metrics["cohort_size"] = sel.valid.to(torch.int32).sum()
            if cfg.exact_oracle_equiv:
                # Scatter to (N, ...) and reuse the oracle contraction:
                # bitwise the oracle run when |S| <= C (zero terms cannot
                # change the sums), at O(N * D) memory.
                own = sel if shard is None else sel._replace(ids=ids_c, weights=w_l, valid=valid_l)
                d_est, sq_err = estimator.aggregate_and_error(
                    fed_cohort.scatter_cohort(deltas_c, own, n),
                    fed_cohort.scatter_cohort(w_l, own, n),
                    lam, shard=shard,
                )
            elif comp is not None:
                d_est, sq_err, norms_c, new_resid = estimator.aggregate_compressed(
                    deltas_c, w_l, lam_l, comp, c_state.get("resid"), shard=shard
                )
            else:
                d_est, sq_err = estimator.aggregate_and_error_cohort(
                    deltas_c, w_l, lam_l, shard=shard)
            if shard is not None:
                norms_c = shard.gather(norms_c, c_slots)
            # The sampler state is (N,): scatter the (C,) feedback.
            feedback = fed_cohort.scatter_cohort(lam_c * norms_c, sel, n, block)

        if ef_on:
            c_state = {"resid": new_resid}
        if async_on:
            # The aggregate enters the stale-delta ring; the server applies
            # only the discounted deltas whose arrival round has come.
            new_buf, apply_vec, _ = stragglers.async_step(
                fault, f_state["buf"], stragglers.tree_to_vec(d_est), t,
                source.async_latency(t, fault.latency), comp,
            )
            f_state = {**f_state, "buf": new_buf}
            d_est = stragglers.vec_to_tree(apply_vec, d_est)
        params, opt_state = cfg.server_opt.apply(params, d_est, opt_state)
        # The server only observes the feedback of the clients it contacted.
        s_state = sampler.update(s_state, draw, feedback)

        if cfg.oracle_metrics:
            if sampler.procedure == "isp":
                p_eff = p_marg
            else:
                # K x the per-draw distribution approximates the inclusion
                # marginal; clipped to (0, 1] as the reference clips it.
                p_eff = torch.clamp(sampler.budget * draw.draw_probs, 1e-30, 1.0)
            cost, opt_cost = regret.round_costs(
                feedback_full, p_eff, sampler.budget, shard=shard, n=n)
            metrics.update(sq_error=sq_err, cost=cost, opt_cost=opt_cost)
            if cfg.track_scores:
                metrics["scores"] = feedback_full
        if eval_data is not None:
            do_eval = t % cfg.eval_every == 0 or t == cfg.rounds - 1
            metrics["accuracy"] = (
                task.accuracy(params, eval_data).to(torch.float32) if do_eval else nan
            )
        out = (params, opt_state, s_state)
        if fault_on:
            out = out + (f_state,)
        if ef_on:
            out = out + (c_state,)
        return out, metrics

    return body


def init_carry(task: Task, sampler: Sampler, cfg: FedConfig, source: RandomSource, device):
    """Round 0's carry: initial parameters from ``source``, the server
    optimizer's and the sampler's initial states, with ``cfg.faults`` the
    fault state, and with error feedback a zero (D,) f32 residual."""
    params = source.init_params(task)
    carry = (params, cfg.server_opt.init(params), sampler.init(device))
    d_dim = stragglers.flat_dim(params)
    if cfg.faults is not None:
        carry = carry + (
            stragglers.fault_state_init(cfg.faults, sampler.n, d_dim, cfg.compression, device),
        )
    if cfg.compression is not None and cfg.compression.error_feedback:
        resid = torch.zeros(d_dim, dtype=torch.float32, device=device)
        carry = carry + ({"resid": resid},)
    return carry


def _to_meta(tree):
    """``tree`` with every tensor leaf replaced by a ``meta`` tensor of its
    shape and dtype (dicts, lists, tuples, dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _to_meta(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def round_body_for_lint(task: Task, dataset: FederatedDataset, sampler: Sampler, cfg: FedConfig,
                        eval_data: tuple | None = None, *, random_source=None):
    """Lintable handle on the built round body: ``(body, (carry, t))``.

    ``body(t, carry)`` is the round ``run_federated`` runs, built on the
    CPU over ``dataset`` and ``random_source`` (default a CPU
    ``PhiloxSource``; its draws are traced as graph nodes); ``carry`` is
    round 0's carry as ``meta`` tensors (shapes and dtypes, no values: the
    task's initial weights are drawn on the CPU and dropped), ``t`` round
    0.  ``repro_torch.analysis.lint`` traces ``body`` on fake tensors of
    the carry's shapes."""
    dev = torch.device("cpu")
    dataset, eval_data, _, carry, body = _setup(
        task, dataset, sampler, cfg, eval_data, dev, random_source)
    return body, (_to_meta(carry), 0)


def _materialize_history(metrics: dict, cfg: FedConfig, has_eval: bool) -> History:
    """Host-side per-round arrays -> the History lists."""
    hist = History(regret=RegretTracker(budget=cfg.budget))
    hist.rounds = list(range(cfg.rounds))
    hist.train_loss = [float(x) for x in metrics["train_loss"]]
    hist.cohort_size = [int(x) for x in metrics["cohort_size"]]
    if "dropped" in metrics:
        hist.cohort_dropped = [int(x) for x in metrics["dropped"]]
    if "deadline_dropped" in metrics:
        hist.deadline_dropped = [int(x) for x in metrics["deadline_dropped"]]
    if cfg.oracle_metrics:
        hist.estimator_sq_error = [float(x) for x in metrics["sq_error"]]
        hist.regret = RegretTracker.from_arrays(
            cfg.budget, metrics["cost"], metrics["opt_cost"], metrics.get("scores")
        )
    if has_eval:
        acc = metrics["accuracy"]
        hist.test_accuracy = [float(a) for a in acc[~np.isnan(acc)]]
    return hist


def _flush_async(params, opt_state, f_state: dict, cfg: FedConfig):
    """End-of-horizon flush of the async ring: the staleness-discounted sum
    of every still-pending delta goes through the server optimizer once,
    after the last round (one host read of the ring's valid flags)."""
    buf = f_state["buf"]
    if not bool(buf["valid"].any()):
        return params
    pending = stragglers.flush_pending(buf, cfg.rounds, float(cfg.faults.staleness_discount))
    params, _ = cfg.server_opt.apply(params, stragglers.vec_to_tree(pending, params), opt_state)
    return params


def _metric_shapes(cfg: FedConfig, n: int, has_eval: bool, score_rows: int) -> dict:
    """Every per-round metric of the round body, before round 0: name ->
    ``(shape, dtype)``, the scores with ``score_rows``, their buffer's rows
    (``fed.state.init_metric_buffers``)."""
    f32, i64 = torch.float32, torch.int64
    shapes = {"train_loss": ((), f32), "cohort_size": ((), i64)}
    if cfg.faults is not None and cfg.faults.deadline is not None:
        shapes["deadline_dropped"] = ((), i64)
    if cfg.oracle_metrics:
        shapes.update(sq_error=((), f32), cost=((), f32), opt_cost=((), f32))
        if cfg.track_scores:
            shapes["scores"] = ((n,), f32, score_rows)
    else:
        shapes["dropped"] = ((), i64)
    if has_eval:
        shapes["accuracy"] = ((), f32)
    return shapes


def _setup(task, dataset, sampler, cfg, eval_data, dev, random_source):
    """The run's dataset and eval batch on ``dev``, its random source, the
    round-0 carry and the round body."""
    if cfg.compression is not None and not cfg.oracle_metrics and cfg.exact_oracle_equiv:
        raise ValueError(
            "compression is incompatible with exact_oracle_equiv: the N-width "
            "scatter path exists to reproduce the oracle contraction bitwise, "
            "which quantization cannot; use the cohort-width aggregation "
            "(exact_oracle_equiv=False)"
        )
    dataset = dataset.to(dev)
    if eval_data is not None:
        eval_data = tuple(
            (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))).to(dev)
            for a in eval_data
        )
    source = PhiloxSource(cfg.seed, dev) if random_source is None else random_source
    carry = init_carry(task, sampler, cfg, source, dev)
    body = _build_round_body(task, dataset, sampler, cfg, eval_data, source)
    return dataset, eval_data, source, carry, body


def build_segment_runner(
    task: Task,
    dataset: FederatedDataset,
    sampler: Sampler,
    cfg: FedConfig,
    eval_data: tuple | None = None,
    *,
    device=None,
    random_source: RandomSource | None = None,
):
    """``(segment_fn, round-0 TrainState)`` of the compiled path.

    The state holds the initial parameters (from the random source), the
    optimizer's and sampler's initial states, zero metric buffers for the
    whole horizon, round 0, the source's state, and the fault and
    error-feedback carries; it is also the restore template of
    ``CheckpointManager.restore_or_init``.  ``segment_fn(state, n)`` runs
    rounds ``state.round .. state.round + n - 1`` (``fed.state``).  The
    state is global; over S > 1 ranks the segment keeps it in
    ``segment_fn.layout`` (``fed.state.StateLayout``)."""
    dev = resolve_device(device)
    dataset, eval_data, source, carry, body = _setup(
        task, dataset, sampler, cfg, eval_data, dev, random_source
    )
    fault_on = cfg.faults is not None
    ef_on = cfg.compression is not None and bool(cfg.compression.error_feedback)
    score_rows = _score_history_plan(cfg, dataset.n_clients)
    shapes = _metric_shapes(cfg, dataset.n_clients, eval_data is not None, score_rows)
    state = TrainState(
        params=carry[0],
        opt_state=carry[1],
        sampler=carry[2],
        metrics=init_metric_buffers(shapes, cfg.rounds, dev),
        round=0,
        source=source.state_dict(),
        faults=carry[3] if fault_on else (),
        compression=carry[-1] if ef_on else (),
    )
    layout = StateLayout(state, sampler) if sampler.splits else None
    segment = make_segment_fn(
        body, source, with_faults=fault_on, with_compression=ef_on, layout=layout)
    return segment, state


def _run_eager(task, dataset, sampler, cfg, eval_data, dev, random_source):
    """``compiled=False``: the same body, each round's metrics copied to the
    host as it ends (the reference's debuggable loop); no ``TrainState``."""
    if not (cfg.oracle_metrics and cfg.track_scores and cfg.score_history_host_offload):
        _score_history_plan(cfg, dataset.n_clients)
    dataset, eval_data, _, carry, body = _setup(
        task, dataset, sampler, cfg, eval_data, dev, random_source
    )
    if sampler.splits:  # this rank's block of the sampler state and the chain
        carry = (*carry[:2], sampler.shard_state(carry[2]), *carry[3:])
        if cfg.faults is not None and "chain" in carry[3]:
            chain = sampler.shard_constrain(carry[3]["chain"])
            carry = (*carry[:3], {**carry[3], "chain": chain}, *carry[4:])
    per_round = []
    for t in range(cfg.rounds):
        carry, m = body(t, carry)
        if "scores" in m and sampler.splits:
            m["scores"] = sampler.shard.gather(m["scores"], sampler.n)
        per_round.append({k: v.cpu().numpy() for k, v in m.items()})
    if per_round:
        metrics = {k: np.stack([m[k] for m in per_round]) for k in per_round[0]}
    else:
        shapes = _metric_shapes(cfg, dataset.n_clients, eval_data is not None, 0)
        metrics = {k: np.zeros((0,) + tuple(v[0])) for k, v in shapes.items()}
    params = carry[0]
    if cfg.faults is not None and int(cfg.faults.async_buffer) > 0:
        params = _flush_async(params, carry[1], carry[3], cfg)
    return params, metrics


def run_federated(
    task: Task,
    dataset: FederatedDataset,
    sampler: Sampler,
    cfg: FedConfig,
    eval_data: tuple | None = None,
    *,
    device=None,
    random_source: RandomSource | None = None,
    ckpt_manager=None,
) -> History:
    """Run Algorithm 1 on ``device`` (default: the GPU; see
    ``repro_torch.device``).

    ``random_source`` supplies every draw (default ``PhiloxSource(cfg.seed,
    device)``); ``eval_data`` is an optional (x, y) batch for the accuracy
    curve (``cfg.eval_every`` schedule).  ``ckpt_manager`` (a
    ``repro_torch.checkpoint.CheckpointManager``, compiled path only, with
    ``cfg.ckpt_every > 0``): restore the latest committed ``TrainState``
    before running and publish one at every segment boundary."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if not cfg.compiled:
        if ckpt_manager is not None:
            raise ValueError(
                "checkpointing exists only for the compiled execution path "
                "(execution.compiled=False has no checkpointable TrainState)"
            )
        params, metrics = _run_eager(task, dataset, sampler, cfg, eval_data, dev, random_source)
    else:
        if ckpt_manager is not None and cfg.ckpt_every <= 0:
            # One whole-horizon segment would publish nothing before the end.
            raise ValueError(
                "run_federated(ckpt_manager=...) needs cfg.ckpt_every > 0; "
                f"got ckpt_every={cfg.ckpt_every}"
            )
        segment, state = build_segment_runner(
            task, dataset, sampler, cfg, eval_data, device=dev, random_source=random_source
        )
        if ckpt_manager is not None:
            state, _ = ckpt_manager.restore_or_init(state)
        on_segment = None
        offload = cfg.oracle_metrics and cfg.track_scores and cfg.score_history_host_offload
        if offload:
            # Segments start at multiples of ckpt_every, so a segment's rows
            # sit at the front of the ring.  Rounds run before a restore (by
            # an earlier process) stay zero.
            scores_host = np.zeros((cfg.rounds, dataset.n_clients), np.float32)
            drained_to = int(state.round)

            def on_segment(st, done):
                nonlocal drained_to
                if segment.layout is not None:
                    st = segment.layout.gather(st, ("metrics",))
                scores_host[drained_to:done] = st.metrics["scores"][: done - drained_to].cpu().numpy()
                drained_to = done

        state = run_segmented(
            state, cfg.rounds, segment, ckpt_every=cfg.ckpt_every, manager=ckpt_manager,
            on_segment=on_segment,
        )
        if segment.layout is not None:
            state = segment.layout.gather(state, ("metrics",))
        params = state.params
        if cfg.faults is not None and int(cfg.faults.async_buffer) > 0:
            params = _flush_async(params, state.opt_state, state.faults, cfg)
        metrics = {k: b.cpu().numpy() for k, b in state.metrics.items()}
        if offload:
            metrics["scores"] = scores_host
    hist = _materialize_history(metrics, cfg, has_eval=eval_data is not None)
    hist.final_params = params_to_numpy(params)
    hist.wall_time_s = time.perf_counter() - t0
    return hist
