"""Promotion gate: held-out-loss scoring and promote/rollback per boundary.

Port of ``repro/serve/gate.py``.  Every checkpoint boundary the watcher
surfaces is scored on a fixed set of held-out batches before it may touch
the engine: ``PromotionGate.consider`` computes the candidate's mean eval
loss (``models.transformer.loss_fn`` under ``torch.no_grad()``, on the
batches' device) and promotes iff the candidate is no worse than the best
loss served so far (within ``tolerance``).  A rejected candidate is a
*rollback*: the engine keeps serving the incumbent weights, and the
decision is recorded either way in the ``PromotionLog``.

The held-out batches follow the eval convention of the simulation stack
(``ServeSpec.eval_batches`` fixed batches of ``FederationSpec.batch_size``
rows): ``heldout_batches`` draws them from the built experiment's
``FederatedDataset`` with a generator of the serving side's own
(``serving_generator``), seeded apart from every stream of the trainer's
random source, so drawing them moves no training stream and a checkpoint's
structure does not depend on them.  A test replays the reference's draws
through ``draws``.

The gate is primed with the served (round-0) parameters: the serving
process starts on the untrained model, so the first trained boundary
normally clears the bar.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.device import resolve_device
from repro_torch.models import transformer

__all__ = [
    "PromotionRecord",
    "PromotionLog",
    "PromotionGate",
    "heldout_batches",
    "serving_generator",
]

# The serving side's streams, named by the reference's fold_in tags: the
# held-out draws (7) and the prompt traffic (11).
HELDOUT_TAG = 7
TRAFFIC_TAG = 11


def serving_generator(seed: int, tag: int) -> torch.Generator:
    """A CPU generator of the serving side, seeded ``(tag << 44) + seed``:
    apart from every ``rng.PhiloxSource`` stream of a training run (seeds
    ``7 * seed + k`` and ``(k << 40) + seed`` for k = 1..3).  On the CPU so
    the draws are the same whichever device serves."""
    return torch.Generator().manual_seed((int(tag) << 44) + int(seed))


def heldout_batches(dataset, *, n_batches: int, batch_size: int, seed: int = 0, draws=None):
    """``n_batches`` fixed (tokens, targets) eval batches from ``dataset``.

    Each batch is one client and ``batch_size`` row indices below that
    client's size, fed to ``dataset.client_batch``.  The client and rows
    come from ``serving_generator(seed, 7)``: per batch the client, then
    its rows.  ``draws`` replaces that generator: one ``(client, rows)``
    pair per batch (how a test replays the reference's
    ``fold_in(PRNGKey(seed), 7)`` draws).  The batches are materialized
    once and reused for every candidate."""
    if draws is None:
        gen = serving_generator(seed, HELDOUT_TAG)
        sizes = dataset.sizes.cpu()
        draws = []
        for _ in range(int(n_batches)):
            client = int(torch.randint(0, dataset.n_clients, (), generator=gen))
            rows = torch.randint(0, int(sizes[client]), (int(batch_size),), generator=gen)
            draws.append((client, rows))
    elif len(draws) != int(n_batches):
        raise ValueError(f"got {len(draws)} held-out draws for n_batches={n_batches}")
    out = []
    for client, rows in draws:
        idx = torch.as_tensor(np.asarray(rows, np.int64)).to(dataset.device)
        if tuple(idx.shape) != (int(batch_size),):
            raise ValueError(f"held-out rows have shape {tuple(idx.shape)}, need ({batch_size},)")
        out.append(dataset.client_batch(int(client), idx))
    return out


@dataclasses.dataclass(frozen=True)
class PromotionRecord:
    """One gate decision: the candidate's step and loss against the incumbent."""

    step: int
    loss: float
    best_loss: float  # best served loss BEFORE this decision
    promoted: bool

    @property
    def reason(self) -> str:
        rel = "<=" if self.promoted else ">"
        return f"loss {self.loss:.4f} {rel} best {self.best_loss:.4f}"


class PromotionLog:
    """Append-only record of every promote/rollback decision."""

    def __init__(self):
        self.records: list[PromotionRecord] = []

    def append(self, record: PromotionRecord) -> None:
        self.records.append(record)

    @property
    def promotions(self) -> int:
        return sum(r.promoted for r in self.records)

    @property
    def rollbacks(self) -> int:
        return sum(not r.promoted for r in self.records)

    def render(self) -> str:
        lines = [
            f"step {r.step:>4} {'PROMOTE' if r.promoted else 'ROLLBACK'} ({r.reason})"
            for r in self.records
        ]
        lines.append(f"{self.promotions} promotions, {self.rollbacks} rollbacks")
        return "\n".join(lines)


class PromotionGate:
    """Score candidates on held-out loss; promote iff no worse than served.

    Parameters
    ----------
    cfg:
        The arch config of the served model.
    batches:
        Fixed (tokens, targets) held-out batches (``heldout_batches``).
    tolerance:
        Promote when ``loss <= best_loss + tolerance``; 0.0 is
        strictly-no-worse.
    device:
        Where the batches live and the loss runs: the engine's device.  By
        default the batches' own device when they are tensors, else the GPU.

    ``launches`` sums the kernel launches of every ``score`` (read from
    ``kernels.launch_counts()`` around it: exact when nothing else launches
    meanwhile), and ``score_seconds`` holds each score's wall seconds.
    """

    def __init__(self, cfg, batches, *, tolerance: float = 0.0, device=None):
        if not batches:
            raise ValueError("PromotionGate needs at least one held-out batch")
        if device is None and isinstance(batches[0][0], torch.Tensor):
            device = batches[0][0].device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batches = [
            tuple(torch.as_tensor(x).to(self.device, torch.int64) for x in (t, y))
            for t, y in batches
        ]
        self.tolerance = float(tolerance)
        self.best_loss: float | None = None
        self.log = PromotionLog()
        self.launches: dict = {}
        self.score_seconds: list[float] = []

    def score(self, params) -> float:
        """Mean held-out loss of ``params`` over the fixed batches."""
        t0 = time.perf_counter()
        before = kernels.launch_counts()
        total = 0.0
        with torch.no_grad():
            for tokens, targets in self.batches:
                total += float(transformer.loss_fn(params, self.cfg, (tokens, targets)))
        for name, n in kernels.launch_counts().items():
            self.launches[name] = self.launches.get(name, 0) + n - before.get(name, 0)
        self.score_seconds.append(time.perf_counter() - t0)
        return total / len(self.batches)

    def prime(self, params) -> float:
        """Set the bar to the served parameters' loss (round-0 weights)."""
        self.best_loss = self.score(params)
        return self.best_loss

    def consider(self, candidate) -> bool:
        """Gate one ``Candidate``: score, decide, record.  True = promote."""
        loss = self.score(candidate.params)
        prev = self.best_loss if self.best_loss is not None else float("inf")
        promoted = loss <= prev + self.tolerance
        self.log.append(
            PromotionRecord(step=int(candidate.step), loss=loss, best_loss=prev, promoted=promoted)
        )
        if promoted:
            self.best_loss = loss
        return promoted
