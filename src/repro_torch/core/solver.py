"""Budgeted water-filling solvers for independent-sampling probabilities.

Port of ``repro/core/solver.py``:

* Lemma 2.2 (ISP): ``min_p sum_i a_i^2 / p_i`` subject to ``sum_i p_i = K``,
  ``0 < p_i <= 1``.
* Lemma 5.1 / Lemma B.8: the same program with a floor ``p_i >= p_min``.
* Lemma 2.2 (RSP): ``p_i = K * a_i / sum_j a_j``.

The KKT system is solved vectorized: ``p_i = clip(a_i / s, p_min, 1)`` for
one water level ``s`` with ``sum_i p_i = K``, and the level is snapped to the
exact rational solution on the bracketed segment (Lemma B.8).  Two paths
share that snap:

* **Single-device** (``_isp_solve``): ``f(s)`` is evaluated at all 2N
  breakpoints through sorted prefix sums (sort, cumsum, searchsorted).
* **Sharded** (``shard=ShardSpec(...)``, ``_isp_solve_sharded``): each shard
  sorts and prefix-sums only its own block; the crossing is bracketed in
  log-space by 64 bisection steps, or with ``use_kernel`` by five passes that
  score a 128-level ladder with the ``waterfill_level_stats`` kernel, and the
  per-shard statistics are merged by ``all_reduce`` on the shard layout's
  process group (``ShardSpec.reduce``; none for one shard).
  Given the global N (``n=``), a rank passes its block of the scores and
  gets its block of p back, as the samplers do when the client axis is
  split; without ``n`` every rank passes the global scores, solves its block
  and gathers p back to (N,).  The snap recomputes
  the active sets from the *local sorted prefix sums* with the single-device
  expressions, so on one shard the result is bitwise equal to ``_isp_solve``;
  across S > 1 shards it differs only by the reassociation of the middle-set
  score sum (~1e-6 relative).  Shard padding uses +inf scores, which never
  enter a count or a sum.

No step copies to the host, so the solve stays on the device inside a
training round.

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
import torch.distributed as dist

from repro_torch.kernels.sharded_waterfill import waterfill_level_stats

__all__ = [
    "isp_probabilities",
    "isp_probabilities_unchecked",
    "rsp_probabilities",
    "mix_probabilities",
    "expected_cost",
    "optimal_cost",
]


def _validate_solver_inputs(scores: torch.Tensor, budget, p_min, n: int | None = None) -> None:
    """Host-side guard: raise on infeasible inputs instead of silently
    returning garbage (``scores`` a rank's block when ``n`` is given)."""
    n = scores.shape[0] if n is None else int(n)
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


# The sharded solve's bracket search (the reference's defaults).
_BISECT_DEPTH = 64
_LADDER_LEVELS = 128
_LADDER_ROUNDS = 5


def _isp_solve_local(
    a_local: torch.Tensor,
    budget: float,
    p_min: float,
    *,
    n_global: int,
    shard=None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Shard-local body of the sharded water-filling solve.

    ``a_local`` is this rank's slice of the scores, possibly +inf-padded
    (infs sort last, sit above every finite threshold and clip to p = 1
    entries the caller drops).  With a splitting ``shard`` the per-shard
    statistics are merged by ``all_reduce`` (SUM for counts and sums, MIN /
    MAX for the bracket's ends); with ``shard=None`` there is no collective.

    The budget crossing of f(s) = sum clip(a_i/s, p_min, 1) is bracketed in
    log2-space, by ``_BISECT_DEPTH`` bisection steps or, with ``use_kernel``,
    by ``_LADDER_ROUNDS`` passes that each score a ``_LADDER_LEVELS``-level
    geometric ladder with ``waterfill_level_stats``.  The bracket is then
    snapped to the exact Lemma B.8 solution through the same local
    sorted-prefix expressions as ``_isp_solve``.  Every step is f32 and
    stays on the device.  ``budget`` / ``p_min`` as in ``_isp_solve``.
    """
    if budget >= n_global:  # degenerate: everything saturates at 1
        return torch.ones_like(a_local)

    def allreduce(x, op=dist.ReduceOp.SUM):
        return x if shard is None else shard.reduce(x, op)

    a_sorted = torch.sort(a_local).values
    prefix = torch.cat([a_sorted.new_zeros(1), torch.cumsum(a_sorted, 0)])
    finite = torch.isfinite(a_sorted)
    a_min = allreduce(torch.where(finite, a_sorted, torch.inf).min(), dist.ReduceOp.MIN)
    a_max = allreduce(torch.where(finite, a_sorted, -torch.inf).max(), dist.ReduceOp.MAX)

    def global_sets(s):
        # _isp_solve's f_and_sets on the LOCAL sorted prefix; the counts and
        # the middle sum are merged across shards.
        n_floor_l = torch.searchsorted(a_sorted, s * p_min, right=True)
        n_below_l = torch.searchsorted(a_sorted, s, right=False)
        c_l = prefix[n_below_l] - prefix[n_floor_l]
        counts = allreduce(torch.stack([n_floor_l, n_below_l]))
        return counts[0], n_global - counts[1], allreduce(c_l)

    # The bracket strictly encloses every breakpoint {a_i, a_i/p_min}:
    # f(2**log_lo) = N >= budget, f(2**log_hi) = N*p_min <= budget.
    log_lo = torch.log2(0.5 * a_min)
    log_hi = torch.log2(2.0 * a_max / p_min)
    if use_kernel:
        n_levels = _LADDER_LEVELS
        t = torch.arange(n_levels, dtype=a_sorted.dtype, device=a_sorted.device) / (n_levels - 1)
        for _ in range(_LADDER_ROUNDS):
            logs = log_lo + t * (log_hi - log_lo)
            levels = torch.exp2(logs)
            stats = allreduce(torch.stack(waterfill_level_stats(a_sorted, levels, levels * p_min)))
            f = (n_global - stats[0]) + stats[1] * p_min + stats[2] / levels
            j = torch.clamp((f >= budget).sum() - 1, min=0)
            log_lo, log_hi = _take(logs, j), _take(logs, torch.clamp(j + 1, max=n_levels - 1))
    else:
        for _ in range(_BISECT_DEPTH):
            l_mid = 0.5 * (log_lo + log_hi)
            s_mid = torch.exp2(l_mid)
            n_floor, n_upper, c = global_sets(s_mid.reshape(1))
            ge = (n_upper + n_floor * p_min + c / s_mid >= budget).reshape(())
            log_lo, log_hi = torch.where(ge, l_mid, log_lo), torch.where(ge, log_hi, l_mid)

    # Snap: inside the bracketed open segment the active sets are fixed;
    # recover them at the (log-)midpoint and solve the Lemma B.8 closed form.
    s_probe = torch.exp2(0.5 * (log_lo + log_hi))
    n_floor, n_upper, c = global_sets(s_probe.reshape(1))
    z = (budget - n_upper - n_floor * p_min).reshape(())
    s_star = torch.where(z > 0, c.reshape(()) / torch.clamp(z, min=1e-30), torch.exp2(log_lo))
    return torch.clamp(a_local / torch.clamp(s_star, min=1e-30), min=p_min, max=1.0)


def _isp_solve_sharded(
    a: torch.Tensor, budget: float, p_min: float, shard, *, use_kernel: bool = False,
    n: int | None = None,
) -> torch.Tensor:
    """Solve over (N,) scores split across ``shard``'s ranks (a
    ``launch.mesh.ShardSpec``).  With ``n`` (the global N) ``a`` is this
    rank's block (``shard.block(n)``) and the result is its block of p;
    without, every rank holds the global scores, solves its block and
    gathers p back to (N,).  A block is +inf-padded to ``ceil(N/S)``."""
    if shard.process_group() is None:
        return _isp_solve_local(a, budget, p_min, n_global=a.shape[0], use_kernel=use_kernel)
    blocks = n is not None
    n = a.shape[0] if n is None else int(n)
    lo, hi = shard.block(n)
    a_local = a if blocks else a[lo:hi]
    m = -(-n // shard.num_shards)
    a_pad = torch.cat([a_local, a.new_full((m - (hi - lo),), torch.inf)])
    p_local = _isp_solve_local(
        a_pad, budget, p_min, n_global=n, shard=shard, use_kernel=use_kernel
    )[: hi - lo]
    return p_local if blocks else shard.gather(p_local, n)


def isp_probabilities_unchecked(
    scores: torch.Tensor,
    budget: float,
    p_min: float = 0.0,
    *,
    shard=None,
    use_kernel: bool | None = None,
    n: int | None = None,
) -> torch.Tensor:
    """``isp_probabilities`` without the host-side validation, for code that
    runs every round; infeasible inputs are clipped (module docstring)."""
    f32 = np.float32
    # A zero floor breaks the bracket; a tiny positive floor plus the snap
    # gives clients with a_i == 0 p = floor ~ 0 (the open-constraint limit).
    p_min_f32 = float(max(f32(p_min), f32(1e-12)))
    safe = torch.clamp(scores, min=1e-30)
    if shard is None:
        return _isp_solve(safe, float(f32(budget)), p_min_f32)
    if use_kernel is None:  # over S > 1 ranks the ladder's 5 passes cost 5 collectives, not 128
        use_kernel = scores.device.type == "cuda" or shard.splits
    return _isp_solve_sharded(
        safe, float(f32(budget)), p_min_f32, shard, use_kernel=use_kernel, n=n
    )


def isp_probabilities(
    scores: torch.Tensor,
    budget: float,
    p_min: float = 0.0,
    *,
    shard=None,
    use_kernel: bool | None = None,
    n: int | None = None,
) -> torch.Tensor:
    """Optimal independent-sampling probabilities (Lemma 2.2 / Lemma 5.1).

    Args:
      scores: non-negative per-client scores ``a_i`` (e.g. ``lambda_i*||g_i||``
        for Lemma 2.2, ``sqrt(pi^2_{1:t-1}(i) + gamma)`` for the FTRL solution).
      budget: expected cohort size ``K`` with ``0 < K <= N``.
      p_min: probability floor (0 recovers Lemma 2.2).
      shard: optional ``launch.mesh.ShardSpec``: solve with the (N,) axis
        split over its process group.  Bitwise equal to the unsharded solve
        on one shard; ~1e-6 on more (module docstring).
      use_kernel: bracket the sharded solve with the ``waterfill_level_stats``
        ladder.  Default (None): on for CUDA tensors and over S > 1 ranks
        (five ``all_reduce``s a solve against the bisection's 128), off for
        CPU tensors on one shard.
      n: the global N when ``scores`` is this rank's block of a split
        client axis (the result is then the block of p); default: the
        scores are global.

    Returns:
      p with ``p_min <= p_i <= 1`` and ``sum(p) == K`` (to float tolerance).

    Raises:
      ValueError: budget outside (0, N], p_min > budget/N, or negative /
        non-finite scores.
    """
    _validate_solver_inputs(scores, budget, p_min, n)
    return isp_probabilities_unchecked(
        scores, budget, p_min, shard=shard, use_kernel=use_kernel, n=n
    )


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


def mix_probabilities(
    p: torch.Tensor, theta: float, budget: float, n: int | None = None
) -> torch.Tensor:
    """Mixing strategy, eq. (12): p~ = (1-theta) p + theta * K/N, with the
    scalar factors rounded as the reference's f32 arithmetic rounds them
    (``n`` the global N when ``p`` is a rank's block)."""
    f32 = np.float32
    keep = float(f32(1.0) - f32(theta))
    floor = float(f32(f32(theta) * f32(budget)) / f32(p.shape[0] if n is None else n))
    return keep * p + floor


def expected_cost(scores: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Online cost l_t(p) = sum_i a_i^2 / p_i (Section 5.1)."""
    return torch.where(scores > 0, scores**2 / torch.clamp(p, min=1e-30), 0.0).sum()


def optimal_cost(scores: torch.Tensor, budget: float, *, shard=None, n=None) -> torch.Tensor:
    """min_p l_t(p) over the ISP polytope — used by regret metrics.  With a
    splitting ``shard``, ``scores`` is this rank's block of the global
    ``n`` and the result is this rank's share of the cost."""
    if shard is None:
        return expected_cost(scores, isp_probabilities_unchecked(scores, budget, 0.0))
    return expected_cost(scores, isp_probabilities_unchecked(scores, budget, 0.0, shard=shard, n=n))
