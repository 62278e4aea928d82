"""Checkpoint watcher: the read side of the manifest hand-off contract.

Port of ``repro/serve/swap.py``.  ``CheckpointWatcher`` follows a
``repro_torch.checkpoint.CheckpointManager`` directory written by a
(possibly still running) training process and turns newly *committed*
steps into restored ``Candidate``s for the promotion gate.  It never
parses checkpoint files on its own: every read goes through the manager,
so the whole contract applies:

* the manifest (``manifest.json``, written via tmp + ``os.replace``) is the
  atomic commit point: a step is visible if and only if its checkpoint
  files were completely written first, so a watcher never sees a torn step;
* ``restore`` checks the manifest's config fingerprint against the
  watcher's manager (train and serve must agree on the spec), then the
  structure hash against the restore template, then every leaf's shape and
  dtype: a candidate that restores has the signature the engine's
  ``swap_params`` pins.

The watcher is strictly monotone: each committed step is surfaced at most
once (``seen_step`` advances on every successful ``poll``), so the serving
loop considers every boundary it sees exactly once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

__all__ = ["Candidate", "CheckpointWatcher"]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One committed checkpoint boundary, restored and ready to score.

    ``params`` is what the promotion gate scores and the engine swaps in;
    ``state`` is the whole restored carry (``fed.state.TrainState`` for the
    zoo stack), kept for provenance."""

    step: int
    params: Any
    state: Any = None


class CheckpointWatcher:
    """Follow a manager directory; surface each new committed step once.

    Parameters
    ----------
    manager:
        A ``CheckpointManager`` opened on the training run's directory with
        the run's config fingerprint (restore refuses a foreign run).
    template:
        The restore template: ``repro_torch.api.restore_template(spec)``'s
        fresh round-0 ``TrainState`` for zoo runs.  Restored tensors land on
        its leaves' devices.
    extract:
        Restored state -> swap payload; the default takes ``.params``
        (the state itself for plain-dict checkpoints).

    ``restore_seconds`` holds each restore's wall seconds.
    """

    def __init__(self, manager, template, *, extract: Callable | None = None):
        self.manager = manager
        self.template = template
        self.extract = extract or (lambda s: getattr(s, "params", s))
        self.seen_step = 0  # committed steps count rounds done, always >= 1
        self.restore_seconds: list[float] = []

    def poll(self) -> Candidate | None:
        """The newest committed step beyond ``seen_step``, restored, or None.

        Steps the trainer published in between are skipped, not queued:
        serving converges on the newest committed boundary."""
        step = self.manager.latest()
        if step is None or int(step) <= self.seen_step:
            return None
        t0 = time.perf_counter()
        state = self.manager.restore(self.template, int(step))
        self.restore_seconds.append(time.perf_counter() - t0)
        self.seen_step = int(step)
        return Candidate(step=int(step), params=self.extract(state), state=state)

    def wait(self, timeout: float) -> Candidate | None:
        """Block for at most ``timeout`` seconds for a step beyond
        ``seen_step`` (``CheckpointManager.wait_for_next``), then restore it."""
        step = self.manager.wait_for_next(self.seen_step, timeout)
        if step is None:
            return None
        return self.poll()
