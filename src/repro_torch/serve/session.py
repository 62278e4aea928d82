"""The serving loop: decode continuously, swap at committed boundaries.

Port of ``repro/serve/session.py``.  ``ServeSession`` composes the three
layers, ``ServeEngine`` (paged-cache decode), ``CheckpointWatcher``
(manifest follow) and ``PromotionGate`` (held-out-loss promote/rollback),
into the closed train-to-serve loop:

    while traffic:
        decode a chunk of tokens (lockstep batch, paged cache)
        wait (bounded) on the manifest for a newly committed boundary
        if one appeared: score it; promote -> hot-swap, rollback -> keep

Decoding never stops for training: the watcher's wait is bounded between
decode chunks, a promoted candidate is copied into the engine's parameter
storage between two decode steps (in-flight sequences keep their caches,
every parameter tensor keeps its address), and a rollback costs one eval.
The loop runs under ``torch.no_grad()``: grad mode is per thread, so a
trainer on another thread of the process keeps its own.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

__all__ = ["ServeSummary", "ServeSession"]


@dataclasses.dataclass
class ServeSummary:
    """What one ``ServeSession.run`` did, for logs and CI assertions."""

    tokens: int
    tokens_per_sec: float
    promotions: int
    rollbacks: int
    swaps: int
    last_step: int
    batches_served: int

    def render(self) -> str:
        # Machine-readable: the reference's CI serve job greps this exact shape.
        return (
            f"serve summary: promotions={self.promotions} "
            f"rollbacks={self.rollbacks} tokens={self.tokens} "
            f"tokens_per_sec={self.tokens_per_sec:.1f} swaps={self.swaps} "
            f"last_step={self.last_step} batches={self.batches_served}"
        )


class ServeSession:
    """Drive an engine under traffic while following a training run.

    Parameters
    ----------
    engine / watcher / gate:
        The three serve layers, already built (the gate primed or not:
        ``run`` primes it with the engine's parameters when
        ``gate.best_loss`` is unset).
    prompt_fn:
        () -> (batch, prompt_len) integer prompts, the traffic source.
        Called for the first batch and at every lockstep refill (cache full
        -> fresh prefill).
    decode_steps_per_poll:
        Decode chunk length between manifest waits: the swap latency /
        throughput knob.
    final_step:
        Stop once a boundary >= this step has been considered (the training
        horizon, ``spec.federation.rounds``).  None: run until ``timeout``.
    on_decision:
        Optional ``(candidate, promoted)`` callback after each gate decision.
    """

    def __init__(
        self,
        engine,
        watcher,
        gate,
        *,
        prompt_fn: Callable,
        decode_steps_per_poll: int = 16,
        final_step: int | None = None,
        on_decision: Callable | None = None,
    ):
        self.engine = engine
        self.watcher = watcher
        self.gate = gate
        self.prompt_fn = prompt_fn
        self.decode_steps_per_poll = int(decode_steps_per_poll)
        self.final_step = final_step
        self.on_decision = on_decision

    @torch.no_grad()
    def run(self, *, timeout: float = 120.0, poll_timeout: float = 0.2) -> ServeSummary:
        """Serve until the training horizon is consumed (or ``timeout``).

        ``poll_timeout`` bounds how long the loop blocks on the manifest
        between decode chunks; decoding never waits longer for the trainer."""
        engine, watcher, gate = self.engine, self.watcher, self.gate
        if gate.best_loss is None:
            gate.prime(engine.params)
        engine.start(self.prompt_fn())
        batches = 1
        deadline = time.monotonic() + float(timeout)
        while True:
            if engine.capacity <= 0:
                engine.start(self.prompt_fn())
                batches += 1
            engine.step(min(self.decode_steps_per_poll, engine.capacity))
            candidate = watcher.wait(poll_timeout)
            if candidate is not None:
                promoted = gate.consider(candidate)
                if promoted:
                    engine.swap_params(candidate.params)
                if self.on_decision is not None:
                    self.on_decision(candidate, promoted)
            done = self.final_step is not None and watcher.seen_step >= self.final_step
            if done or time.monotonic() >= deadline:
                break
        return ServeSummary(
            tokens=engine.decode_tokens,
            tokens_per_sec=engine.tokens_per_sec(),
            promotions=gate.log.promotions,
            rollbacks=gate.log.rollbacks,
            swaps=engine.swaps,
            last_step=watcher.seen_step,
            batches_served=batches,
        )
