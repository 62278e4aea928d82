"""Regret and sampling-quality metrics (Sections 4-5).

* dynamic regret   Regret_D(T) = sum_t l_t(p^t) - sum_t min_p l_t(p)   (eq. 8)
* static  regret   Regret_S(T) = sum_t l_t(p^t) - min_p sum_t l_t(p)   (eq. 9)
* sampling quality Q(S^t) upper bound l_t(p^t) - l_t(p*)               (Sec 5.1)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import solver

__all__ = ["RegretTracker", "round_costs"]


def round_costs(
    full_scores: torch.Tensor, p_used: torch.Tensor, budget: float, *, shard=None, n=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-round online costs on the device: (l_t(p^t), min_p l_t(p)).  The
    server keeps them in per-round buffers and builds a ``RegretTracker``
    view once at the end (``RegretTracker.from_arrays``).

    With a ``shard`` that splits the client axis, ``full_scores`` and
    ``p_used`` are this rank's blocks of the global ``n``: the optimum is
    the split solve, and both sums over N are one ``all_reduce``."""
    if shard is None:
        return solver.expected_cost(full_scores, p_used), solver.optimal_cost(full_scores, budget)
    costs = shard.sum(torch.stack([
        solver.expected_cost(full_scores, p_used),
        solver.optimal_cost(full_scores, budget, shard=shard, n=n),
    ]))
    return costs[0], costs[1]


@dataclasses.dataclass
class RegretTracker:
    """Per-round online costs from *full* feedback (simulation-side oracle
    knowledge — available in experiments, not on a real server)."""

    budget: int
    costs: list = dataclasses.field(default_factory=list)  # l_t(p^t)
    opt_costs: list = dataclasses.field(default_factory=list)  # min_p l_t(p)
    score_history: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_arrays(cls, budget: int, costs, opt_costs, score_history=None) -> "RegretTracker":
        """View over stacked per-round buffers (T,), (T,), (T, N) (host numpy).
        ``score_history=None`` (``track_scores=False``) gives an empty history."""
        hist = np.zeros((0, 0)) if score_history is None else np.asarray(score_history)
        return cls(
            budget=budget,
            costs=[float(c) for c in np.asarray(costs)],
            opt_costs=[float(c) for c in np.asarray(opt_costs)],
            score_history=[hist[t] for t in range(hist.shape[0])],
        )

    def dynamic_regret(self) -> np.ndarray:
        """Cumulative eq. (8) per round."""
        return np.cumsum(np.asarray(self.costs) - np.asarray(self.opt_costs))

    def static_regret(self) -> float:
        """eq. (9) first term: vs the best fixed p in hindsight."""
        if not self.score_history:
            raise ValueError(
                "static_regret needs score_history; this run recorded none "
                "(FedConfig.track_scores=False or no rounds)"
            )
        hist = torch.from_numpy(np.stack(self.score_history).astype(np.float32))
        cum_sq = torch.sqrt((hist**2).sum(0))  # sqrt(pi^2_{1:T}(i))
        p_star = solver.isp_probabilities(cum_sq, self.budget)
        best_fixed = sum(float(solver.expected_cost(s, p_star)) for s in hist)
        return float(np.sum(self.costs) - best_fixed)

    def quality_gap(self) -> np.ndarray:
        """Per-round Q(S^t) upper bound l_t(p^t) - l_t(p^*_t)."""
        return np.asarray(self.costs) - np.asarray(self.opt_costs)
