"""Budgeted water-filling solvers for independent-sampling probabilities.

Port of ``repro/core/solver.py``, single-device path:

* Lemma 2.2 (ISP): ``min_p sum_i a_i^2 / p_i`` subject to ``sum_i p_i = K``,
  ``0 < p_i <= 1``.
* Lemma 5.1 / Lemma B.8: the same program with a floor ``p_i >= p_min``.
* Lemma 2.2 (RSP): ``p_i = K * a_i / sum_j a_j``.

The KKT system is solved vectorized: ``p_i = clip(a_i / s, p_min, 1)`` for
one water level ``s`` with ``sum_i p_i = K``.  ``f(s)`` is evaluated at all
2N breakpoints through sorted prefix sums (sort, cumsum, searchsorted), and
the level is snapped to the exact rational solution on the bracketed segment
(Lemma B.8).  No step copies to the host, so the solve stays on the device
inside a training round.

Validation: only the public ``isp_probabilities`` checks its inputs (and
copies the scores to the host to do so), raising ``ValueError`` for
``budget`` outside ``(0, N]``, ``p_min`` outside ``[0, budget/N]``, or
negative / non-finite scores.  The samplers and the regret diagnostics call
``isp_probabilities_unchecked``, which clips as the reference's traced path
does: scores through ``max(a, 1e-30)``, the floor through
``max(p_min, 1e-12)``, and ``budget >= N`` through full saturation.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "isp_probabilities",
    "isp_probabilities_unchecked",
    "rsp_probabilities",
    "mix_probabilities",
    "expected_cost",
    "optimal_cost",
]


def _validate_solver_inputs(scores: torch.Tensor, budget, p_min) -> None:
    """Host-side guard: raise on infeasible inputs instead of silently
    returning garbage."""
    n = scores.shape[0]
    b = float(budget)
    pm = float(p_min)
    if not 0.0 < b <= n:
        raise ValueError(
            f"budget must satisfy 0 < budget <= N; got budget={b} with N={n}"
        )
    if pm < 0.0 or pm > b / n * (1.0 + 1e-6):
        raise ValueError(
            f"p_min must satisfy 0 <= p_min <= budget/N = {b / n:.6g}; "
            f"got p_min={pm} (the paper's regime is p_min <= K/(2N))"
        )
    s = scores.detach().cpu()
    if not bool(torch.isfinite(s).all()):
        raise ValueError("scores must be finite (got NaN or inf)")
    if bool((s < 0).any()):
        raise ValueError(
            f"scores must be non-negative; min score = {float(s.min())} "
            "(zero scores are legal: those clients sit at the floor)"
        )


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, as a device gather (indexing with a
    0-d tensor would read it on the host)."""
    return x.gather(0, i.reshape(1)).reshape(())


def _isp_solve(a: torch.Tensor, budget: float, p_min: float) -> torch.Tensor:
    """Solve min sum a_i^2/p_i s.t. sum p = budget, p_min <= p <= 1.

    f(s) = sum_i clip(a_i/s, p_min, 1) is monotone non-increasing with
    breakpoints at s = a_i (cap) and s = a_i / p_min (floor).  Evaluate f at
    all 2N breakpoints via sorted prefix sums, find the segment bracketing
    the budget and solve its closed form s* = c / z with c = sum of middle
    scores, z = budget - |U| - |L| p_min — exactly Lemma B.8.

    Requires a_i > 0 and 0 < p_min <= budget/N.  ``budget`` and ``p_min``
    are Python floats holding f32 values: PyTorch computes a tensor-scalar
    op in the tensor's dtype, as the reference computes with f32 arrays,
    and no scalar is copied to the device.
    """
    n = a.shape[0]
    if budget >= n:  # degenerate: everything saturates at 1
        return torch.ones_like(a)
    a_sorted = torch.sort(a).values
    prefix = torch.cat([a.new_zeros(1), torch.cumsum(a_sorted, 0)])

    def f_and_sets(s):
        # |L| = #{a_i <= s*p_min}; |U| = #{a_i >= s}; middle sum via prefix.
        n_lower = torch.searchsorted(a_sorted, s * p_min, right=True)
        n_not_upper = torch.searchsorted(a_sorted, s, right=False)
        n_upper = n - n_not_upper
        c = prefix[n_not_upper] - prefix[n_lower]
        f = n_upper + n_lower * p_min + c / s
        return f, n_lower, n_upper, c

    bps = torch.sort(torch.cat([a_sorted, a_sorted / p_min])).values
    f_at_bps = f_and_sets(bps)[0]
    # f is non-increasing along bps: the solution lies in [bps[j], bps[j+1]]
    # with j the last breakpoint where f >= budget.
    j = torch.clamp((f_at_bps >= budget).sum() - 1, min=0)
    lo = _take(bps, j)
    hi = _take(bps, torch.clamp(j + 1, max=2 * n - 1))
    s_probe = 0.5 * (lo + hi)
    # Inside the open segment the active sets are fixed: recover them at the
    # midpoint and solve the closed form.
    _, n_lower, n_upper, c = f_and_sets(s_probe.reshape(1))
    z = (budget - n_upper - n_lower * p_min).reshape(())
    s_star = torch.where(z > 0, c.reshape(()) / torch.clamp(z, min=1e-30), lo)
    return torch.clamp(a / torch.clamp(s_star, min=1e-30), min=p_min, max=1.0)


def isp_probabilities_unchecked(
    scores: torch.Tensor, budget: float, p_min: float = 0.0
) -> torch.Tensor:
    """``isp_probabilities`` without the host-side validation, for code that
    runs every round; infeasible inputs are clipped (module docstring)."""
    f32 = np.float32
    # A zero floor breaks the bracket; a tiny positive floor plus the snap
    # gives clients with a_i == 0 p = floor ~ 0 (the open-constraint limit).
    p_min_f32 = float(max(f32(p_min), f32(1e-12)))
    return _isp_solve(torch.clamp(scores, min=1e-30), float(f32(budget)), p_min_f32)


def isp_probabilities(
    scores: torch.Tensor, budget: float, p_min: float = 0.0
) -> torch.Tensor:
    """Optimal independent-sampling probabilities (Lemma 2.2 / Lemma 5.1).

    Args:
      scores: non-negative per-client scores ``a_i`` (e.g. ``lambda_i*||g_i||``
        for Lemma 2.2, ``sqrt(pi^2_{1:t-1}(i) + gamma)`` for the FTRL solution).
      budget: expected cohort size ``K`` with ``0 < K <= N``.
      p_min: probability floor (0 recovers Lemma 2.2).

    Returns:
      p with ``p_min <= p_i <= 1`` and ``sum(p) == K`` (to float tolerance).

    Raises:
      ValueError: budget outside (0, N], p_min > budget/N, or negative /
        non-finite scores.
    """
    _validate_solver_inputs(scores, budget, p_min)
    return isp_probabilities_unchecked(scores, budget, p_min)


def rsp_probabilities(scores: torch.Tensor, budget: float) -> torch.Tensor:
    """Optimal marginals for the random sampling procedure: K * a / sum(a).

    Clipped to 1 with iterative mass redistribution so the result stays a
    valid marginal vector when K * max(a) > sum(a).
    """
    budget = float(np.float32(budget))
    total = torch.clamp(scores.sum(), min=1e-30)
    p = budget * scores / total
    for _ in range(8):
        capped = p >= 1.0
        k_rem = budget - capped.sum()
        denom = torch.where(capped, 0.0, scores).sum()
        p = torch.where(capped, 1.0, k_rem * scores / torch.clamp(denom, min=1e-30))
    return torch.clamp(p, 0.0, 1.0)


def mix_probabilities(p: torch.Tensor, theta: float, budget: float) -> torch.Tensor:
    """Mixing strategy, eq. (12): p~ = (1-theta) p + theta * K/N, with the
    scalar factors rounded as the reference's f32 arithmetic rounds them."""
    f32 = np.float32
    keep = float(f32(1.0) - f32(theta))
    floor = float(f32(f32(theta) * f32(budget)) / f32(p.shape[0]))
    return keep * p + floor


def expected_cost(scores: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Online cost l_t(p) = sum_i a_i^2 / p_i (Section 5.1)."""
    return torch.where(scores > 0, scores**2 / torch.clamp(p, min=1e-30), 0.0).sum()


def optimal_cost(scores: torch.Tensor, budget: float) -> torch.Tensor:
    """min_p l_t(p) over the ISP polytope — used by regret metrics."""
    return expected_cost(scores, isp_probabilities_unchecked(scores, budget, 0.0))
