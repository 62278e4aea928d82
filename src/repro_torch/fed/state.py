"""The federated run's carry (``TrainState``) and the segmented driver.

Port of ``repro/fed/state.py``.  The horizon runs as segments of
``ckpt_every`` rounds driven from a host loop that can publish a checkpoint
(``repro_torch.checkpoint.CheckpointManager``) at every boundary.
``TrainState`` is the one object that crosses segment boundaries and
checkpoints; everything a resumed process needs to continue the run bit for
bit is in it:

* ``params``, ``opt_state`` — model parameters and server-optimizer state;
* ``sampler``    — the sampler's online state (``core.samplers``
                   serializable-state contract);
* ``metrics``    — dict of device ``(T, ...)`` per-round metric buffers,
                   allocated for the whole horizon before round 0
                   (``init_metric_buffers``) and written row by row, so a
                   resumed run's ``History`` covers the rounds run before
                   the preemption;
* ``round``      — int: the next round to run;
* ``source``     — the random source's state (``RandomSource.state_dict``:
                   each Philox stream's generator state; empty for a
                   replayed source).  It takes the place of the reference's
                   PRNG ``key``: the port's streams draw in round order, so
                   a resumed run draws what the uninterrupted run drew only
                   if every generator resumes where it stopped;
* ``faults``     — the fault layer's carried state (Markov chain, async
                   ring) with a fault section, else ``()``;
* ``compression``— ``{"resid": (D,) f32}`` with error feedback, else ``()``.

Segmentation is a pure reshaping of the horizon: for any ``ckpt_every`` the
round bodies see the same carries, draws and round indices, so results are
bitwise those of one segment.

Over S > 1 ranks (a sampler whose ``ShardSpec`` splits the client axis),
``build_placement`` says where each leaf lives at rest, by the reference's
rules: the leading (N,) axis of the sampler's leaves and of the Markov
chain and the trailing (N,) axis of the metric buffers (the oracle score
history) split into the rank's block, everything else replicated; when S
does not divide N those leaves stay replicated at rest.  The round body
always computes on blocks.  ``StateLayout`` moves a state between the
three forms: global (a fresh round-0 state, a restored checkpoint), at
rest (between segments) and computing (inside a segment).  A checkpoint
holds the global state: ``run_segmented`` gathers the split leaves and
rank 0 writes them, and the next segment slices each rank's block out of a
restored global state, so a run saved at one S resumes at another.  The
ranks of a ``model`` axis replicate their data block: only the rank at
mesh coordinate 0 writes (``launch.mesh.is_writer``), and with no split
leaf the replicated ranks wait for its write.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import tree_flatten, tree_unflatten
from repro_torch.launch.mesh import is_writer, world_size

__all__ = [
    "TrainState", "StateLayout", "build_placement", "init_metric_buffers", "make_segment_fn",
    "run_segmented", "segment_builds",
]


@dataclasses.dataclass
class TrainState:
    """The federated run's carry (see module docstring)."""

    params: Any
    opt_state: Any
    sampler: Any
    metrics: Any
    round: int  # the next round to run
    source: Any  # the random source's state_dict()
    faults: Any = ()
    compression: Any = ()


def init_metric_buffers(metric_shapes: dict, total_rounds: int, device) -> dict:
    """Zero ``(rows, *shape)`` buffers for ``metric_shapes``: name ->
    ``(shape, dtype)`` or ``(shape, dtype, rows)``, rows defaulting to
    ``total_rounds`` (a shorter buffer is a ring, written at ``t mod rows``:
    the score-history host offload)."""
    out = {}
    for name, spec in metric_shapes.items():
        shape, dtype = spec[0], spec[1]
        rows = spec[2] if len(spec) > 2 else total_rounds
        out[name] = torch.zeros((int(rows),) + tuple(shape), dtype=dtype, device=device)
    return out


def _map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_flatten(tree)])


def build_placement(template: TrainState, sampler, *, divisible: bool | None = None) -> TrainState:
    """Each leaf's layout over the client shards, as a ``TrainState`` of the
    template's structure: None where the leaf is replicated, else the
    dimension of size N that is split into ``sampler.shard``'s blocks.

    ``template`` is the global state (tensors, ``meta`` tensors included:
    only shapes are read).  The reference's rules
    (``repro/fed/state.py:build_placement``): the sampler's leaves with a
    leading (N,) axis split it, and so does the fault layer's Markov
    ``chain``; metric buffers with a trailing (N,) axis (ndim >= 2) split
    that; the parameters, optimizer state, round, random source, the async
    ring and the error-feedback residual are replicated.  When S does not
    divide N the split leaves fall back to replicated (``divisible``,
    default ``N % S == 0``; the segments compute on blocks either way).
    The async ring is replicated by name, where the reference's shape rule
    would split a ring of exactly N slots.  A field replicated whole (the
    parameters, the optimizer state, the round, the source, the residual)
    is one None, whatever its leaves."""
    n = int(sampler.n)
    if divisible is None:
        divisible = n % sampler.shard.num_shards == 0

    def leading(leaf):
        shape = getattr(leaf, "shape", ())
        return 0 if divisible and len(shape) >= 1 and shape[0] == n else None

    def trailing(leaf):
        shape = getattr(leaf, "shape", ())
        return len(shape) - 1 if divisible and len(shape) >= 2 and shape[-1] == n else None

    faults = template.faults
    if isinstance(faults, dict):
        faults = {k: (_map(leading, v) if k == "chain" else _map(lambda _: None, v))
                  for k, v in faults.items()}
    return TrainState(
        params=None,
        opt_state=None,
        sampler=_map(leading, template.sampler),
        metrics=_map(trailing, template.metrics),
        round=None,
        source=None,
        faults=faults,
        compression=None,
    )


class StateLayout:
    """A ``TrainState``'s layout over ``sampler.shard``'s S > 1 ranks.

    ``rest`` is ``build_placement`` (the layout between segments),
    ``compute`` the same rules with every (N,) axis split (the round body
    computes on blocks).  A state passes through three forms: global,
    at rest and computing; a split leaf's block is ``shard.block(N)``
    (``launch.mesh.ShardSpec.local_range``)."""

    def __init__(self, template: TrainState, sampler):
        self.shard = sampler.shard
        self.n = int(sampler.n)
        self.rank = self.shard.rank()
        self.lo, self.hi = self.shard.local_range(self.n, self.rank)
        self.rest = build_placement(template, sampler)
        self.compute = build_placement(template, sampler, divisible=True)

    def _local(self, leaf, dim):
        rows = leaf.shape[dim]
        if rows == self.n:
            return leaf.narrow(dim, self.lo, self.hi - self.lo).clone()
        if rows != self.hi - self.lo:
            raise ValueError(
                f"a leaf of shape {tuple(leaf.shape)} has {rows} rows along dim {dim}: neither "
                f"the {self.n} clients nor rank {self.rank}'s block [{self.lo}, {self.hi})"
            )
        return leaf  # already this rank's block

    def _global(self, leaf, dim):
        if leaf.shape[dim] == self.n and self.hi - self.lo != self.n:
            return leaf
        return self.shard.gather(leaf.movedim(dim, 0), self.n).movedim(0, dim).contiguous()

    def _apply(self, state: TrainState, fn, fields=None) -> TrainState:
        """``state`` with ``fn(leaf, rest dim, compute dim)`` applied to the
        leaves of ``fields`` (default: all)."""
        out = {}
        for f in dataclasses.fields(TrainState):
            if (fields is not None and f.name not in fields) or getattr(self.rest, f.name) is None:
                continue  # a field replicated whole
            sub = getattr(state, f.name)
            leaves = tree_flatten(sub)
            rest, comp = tree_flatten(getattr(self.rest, f.name)), tree_flatten(
                getattr(self.compute, f.name))
            if len(leaves) != len(rest):
                raise ValueError(
                    f"TrainState.{f.name} has {len(leaves)} leaves, its layout {len(rest)}"
                )
            out[f.name] = tree_unflatten(sub, [fn(x, r, c) for x, r, c in zip(leaves, rest, comp)])
        return dataclasses.replace(state, **out)

    def to_compute(self, state: TrainState) -> TrainState:
        """Global or at rest -> every split leaf this rank's block."""
        return self._apply(state, lambda x, r, c: x if c is None else self._local(x, c))

    def to_rest(self, state: TrainState) -> TrainState:
        """Computing -> at rest: the leaves replicated at rest are gathered."""
        return self._apply(
            state, lambda x, r, c: x if c is None or r is not None else self._global(x, c)
        )

    def gather(self, state: TrainState, fields: tuple | None = None) -> TrainState:
        """Any form -> global (``fields``: only those ``TrainState`` fields)."""
        return self._apply(state, lambda x, r, c: x if c is None else self._global(x, c), fields)

    def check(self, state: TrainState, where: str) -> None:
        """Raise ``ValueError`` unless every split leaf has its at-rest size
        along its split dimension (the block, or N where replicated)."""

        def one(x, r, c):
            want = self.hi - self.lo if r is not None else self.n
            if c is not None and x.shape[c] != want:
                raise ValueError(
                    f"{where}: a leaf of shape {tuple(x.shape)} has {x.shape[c]} rows along "
                    f"dim {c}, its layout holds {want} (rank {self.rank}, block "
                    f"[{self.lo}, {self.hi}) of {self.n})"
                )
            return x

        self._apply(state, one)

    def barrier(self) -> None:
        """Wait for every rank (one ``broadcast`` from rank 0)."""
        self.shard.broadcast(torch.zeros(1))


_BUILDS = [0]


def segment_builds() -> int:
    """How many segment functions ``make_segment_fn`` has built in this
    process: a run builds one, and a resume one more (the compile-once
    audit of ``repro_torch.analysis.lint`` reads it)."""
    return _BUILDS[0]


def make_segment_fn(body, source, *, with_faults: bool = False, with_compression: bool = False,
                    layout: StateLayout | None = None):
    """The one segment function over ``TrainState``: ``segment(state,
    n_rounds)``

    1. loads ``state.source`` into ``source`` (the generators resume where
       the state was taken);
    2. runs ``body(t, carry)`` for ``t = state.round .. state.round +
       n_rounds - 1`` on the carry ``(params, opt_state, sampler)``, plus
       ``state.faults`` when ``with_faults`` and ``state.compression`` when
       ``with_compression``;
    3. writes each round's metrics into the buffers at row ``t mod rows``
       (identity for full-horizon buffers), refusing a metric whose shape
       or dtype differs from its buffer's;
    4. returns the advanced ``TrainState`` with ``source.state_dict()``.

    The buffers are written in place: the input state's metrics are the
    output's (the reference donates its input state).

    With a ``layout`` (S > 1 ranks) the input state may be global or at
    rest: each split leaf is cut to this rank's block before the rounds,
    and the output is at rest, every leaf's local shape checked against
    the layout (``StateLayout.check``); the buffers are then the segment's
    own.  ``segment.layout`` is the layout (``run_segmented`` gathers by
    it before a save)."""

    def segment(state: TrainState, n_rounds: int) -> TrainState:
        if layout is not None:
            state = layout.to_compute(state)
        source.load_state_dict(state.source)
        carry = (state.params, state.opt_state, state.sampler)
        if with_faults:
            carry = carry + (state.faults,)
        if with_compression:
            carry = carry + (state.compression,)
        metrics = state.metrics
        for t in range(int(state.round), int(state.round) + int(n_rounds)):
            carry, m = body(t, carry)
            for k, v in m.items():
                buf = metrics[k]
                if v.dtype != buf.dtype or tuple(v.shape) != tuple(buf.shape[1:]):
                    raise ValueError(
                        f"metric {k!r}: round {t} gave {v.dtype} {tuple(v.shape)}, its buffer "
                        f"holds {buf.dtype} {tuple(buf.shape[1:])} (init_metric_buffers)"
                    )
                buf[t % buf.shape[0]] = v
        c_state = carry[-1] if with_compression else state.compression
        carry = carry[:-1] if with_compression else carry
        f_state = carry[-1] if with_faults else state.faults
        params, opt_state, s_state = carry[:3]
        out = TrainState(
            params=params,
            opt_state=opt_state,
            sampler=s_state,
            metrics=metrics,
            round=int(state.round) + int(n_rounds),
            source=source.state_dict(),
            faults=f_state,
            compression=c_state,
        )
        if layout is not None:
            out = layout.to_rest(out)
            layout.check(out, f"segment end at round {out.round}")
        return out

    _BUILDS[0] += 1
    segment._lint = {"build": _BUILDS[0]}  # the compile-once audit's handle
    segment.layout = layout
    return segment


def run_segmented(
    state: TrainState,
    total_rounds: int,
    segment_fn: Callable[[TrainState, int], TrainState],
    *,
    ckpt_every: int = 0,
    manager=None,
    on_segment: Callable[[TrainState, int], None] | None = None,
    max_segments: int | None = None,
    publish: Callable[[TrainState, int], None] | None = None,
) -> TrainState:
    """Host loop over segments of ``ckpt_every`` rounds from ``state.round``
    to ``total_rounds`` (``ckpt_every <= 0``: the rest as one segment).

    After each segment, in the reference's order: ``manager.save(state,
    step=rounds_done)`` (the manifest write commits it), then
    ``publish(state, rounds_done)``, then ``on_segment(state, rounds_done)``,
    then the ``max_segments`` check, which stops the loop early (cooperative
    preemption; the resume tests' simulated kill).  ``publish`` needs a
    manager: it announces committed boundaries.  Returns the final (or
    preempted) state; ``state.round`` says how far it got.

    Over S > 1 ranks (``segment_fn.layout``) every rank calls this: the
    save gathers the split leaves to their global shapes, rank 0 writes
    them, and every rank waits for the write before going on."""
    if publish is not None and manager is None:
        raise ValueError(
            "run_segmented(publish=...) requires a manager: the publish hook "
            "announces COMMITTED checkpoint boundaries, and only the "
            "manager's manifest write commits one"
        )
    done = int(state.round)
    if done > total_rounds:
        raise ValueError(f"state.round={done} is past the horizon total_rounds={total_rounds}")
    seg = int(ckpt_every) if ckpt_every and ckpt_every > 0 else int(total_rounds)
    layout = getattr(segment_fn, "layout", None)
    n_segments = 0
    while done < total_rounds:
        n = min(seg, total_rounds - done)
        state = segment_fn(state, n)
        done += n
        if manager is not None:
            if layout is None:
                if is_writer():
                    manager.save(state, step=done)
                if world_size() > 1:  # replicated ranks wait for the writer
                    dist.barrier()
            else:
                full = layout.gather(state)
                if is_writer():
                    manager.save(full, step=done)
                layout.barrier()
            if publish is not None:
                publish(state, done)
        if on_segment is not None:
            on_segment(state, done)
        n_segments += 1
        if max_segments is not None and n_segments >= max_segments:
            break
    return state
