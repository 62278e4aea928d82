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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = [
    "TrainState", "init_metric_buffers", "make_segment_fn", "run_segmented", "segment_builds",
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


_BUILDS = [0]


def segment_builds() -> int:
    """How many segment functions ``make_segment_fn`` has built in this
    process: a run builds one, and a resume one more (the compile-once
    audit of ``repro_torch.analysis.lint`` reads it)."""
    return _BUILDS[0]


def make_segment_fn(body, source, *, with_faults: bool = False, with_compression: bool = False):
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
    output's (the reference donates its input state)."""

    def segment(state: TrainState, n_rounds: int) -> TrainState:
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
        return TrainState(
            params=params,
            opt_state=opt_state,
            sampler=s_state,
            metrics=metrics,
            round=int(state.round) + int(n_rounds),
            source=source.state_dict(),
            faults=f_state,
            compression=c_state,
        )

    _BUILDS[0] += 1
    segment._lint = {"build": _BUILDS[0]}  # the compile-once audit's handle
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
    preempted) state; ``state.round`` says how far it got."""
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
    n_segments = 0
    while done < total_rounds:
        n = min(seg, total_rounds - done)
        state = segment_fn(state, n)
        done += n
        if manager is not None:
            manager.save(state, step=done)
            if publish is not None:
                publish(state, done)
        if on_segment is not None:
            on_segment(state, done)
        n_segments += 1
        if max_segments is not None and n_segments >= max_segments:
            break
    return state
