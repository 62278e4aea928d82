"""Client samplers: K-Vib (Algorithm 2) and the paper's baselines.

Port of ``repro/core/samplers.py``.  A sampler is a frozen configuration
object with pure functions over an explicit state::

    sampler = KVib(n=N, budget=K, horizon=T)
    state   = sampler.init(device)
    probs   = sampler.probabilities(state)           # marginals, or RSP's per-draw p
    draw    = sampler.sample_from(probs, draw_input) # SampleResult
    state   = sampler.update(state, draw, feedback)

``feedback`` is the paper's ``pi_t(i) = lambda_i * ||g_i^t||`` for the
clients in the cohort (zeros elsewhere); the importance correction by the
sampling probability happens inside ``update``.

Two sampling procedures, as in the reference (Section 2 of the paper):

* ISP (``procedure="isp"``): an independent Bernoulli draw per client;
* RSP: K draws from a distribution over clients, with replacement
  (``"rsp_wr"``: Vrb, Mabs, Avare, Osmd; ``SampleResult.counts`` counts a
  client's draws) or uniform without replacement (``"rsp_wor"``: vanilla
  FedAvg's ``UniformRSP``).

Randomness is injected: ``sample_from`` takes its draw's input from the
run's random source (``repro_torch.rng``) instead of a key, by procedure
(``draw_input``): the (N,) uniforms of the Bernoulli draw, the (K,) uniforms
of the draw with replacement, or the (K,) clients of the draw without.  A
test can then replay the reference's own draws.  Every state field is a
tensor on the run's device (the round counter included), so a round never
reads the device from the host.

With ``shard=ShardSpec(...)`` (``launch.mesh``) the water-filling solves of
K-Vib, ClusteredKVib and OptimalISP run split over the layout's process
group (``solver.isp_probabilities(..., shard=...)``).  When the layout
splits the client axis over S > 1 ranks, each rank holds its block of every
(N,) value (``shard_constrain`` / ``shard_state`` cut it out of a global
one): the state, the probabilities, the draw and the feedback.  Every rank
draws the same global inputs from the same random source and keeps its
block, so S ranks draw what one draws.  What reduces over all N goes
through a collective of the layout (``ShardSpec.sum`` / ``max`` /
``gather``), by sampler:

* ``uniform_isp``: none; the ISP draw's ``draw_probs`` normalisation is one
  ``all_reduce`` (every ISP sampler);
* ``kvib``: the split solve (``all_reduce``s of counts and sums) and, in
  round 0 with an automatic gamma, one ``all_reduce`` for ``_g_sq``;
* ``optimal_isp``: the split solve and one ``all_reduce`` (any score > 0);
* ``clustered_kvib``: one ``all_gather`` of the statistics (the cluster
  means run over the clients in cluster order), the split solve, ``_g_sq``;
* ``vrb``: an ``all_reduce`` of the weights' sum, ``_g_sq``;
* ``mabs``: ``all_reduce``s of the statistics' max and the weights' sum,
  and of the largest drawn feedback in the update;
* ``avare``: ``all_reduce``s of the explored flag, the largest estimate and
  two normalising sums;
* ``osmd``: ``all_reduce``s of the gradient's largest magnitude, the
  softmax's max and sum, and the renormalising sum;
* RSP draws with replacement (``vrb``, ``mabs``, ``avare``, ``osmd``): one
  ``all_gather`` of the distribution, then every rank draws the same K from
  the whole vector and keeps its block of the counts; ``uniform_rsp``
  draws the same K clients everywhere with no collective.

The serializable-state contract of the reference holds here too
(``assert_serializable_state``): every leaf of a state is a tensor, none is
float64 or complex128, and static configuration lives on the sampler, not
in its state.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import solver
from repro_torch.launch.mesh import ShardSpec

__all__ = [
    "SampleResult",
    "SamplerState",
    "Sampler",
    "UniformISP",
    "UniformRSP",
    "KVib",
    "Vrb",
    "Mabs",
    "Avare",
    "OptimalISP",
    "Osmd",
    "ClusteredKVib",
    "draw_input",
    "make_sampler",
    "sampler_names",
    "assert_serializable_state",
]


def _state_leaves(state) -> list:
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return [x for f in dataclasses.fields(state) for x in _state_leaves(getattr(state, f.name))]
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _state_leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _state_leaves(v)]
    return [state]


def assert_serializable_state(state) -> None:
    """The reference's serializable-state contract: raises ``ValueError``
    on a state with no leaves, and ``TypeError`` if a leaf is not a tensor
    (a Python scalar in the state would not survive a checkpoint) or is
    float64 / complex128 (doubles the checkpoint and breaks bitwise resume
    across platforms).  torch has no weak types, the reference's third
    refusal."""
    leaves = _state_leaves(state)
    if not leaves:
        raise ValueError(
            "sampler state has no tensor leaves; nothing would survive a checkpoint round trip"
        )
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(
                f"sampler-state leaf {i} is {type(leaf).__name__}, not a tensor: a Python "
                "scalar in the state is dropped from checkpoints (serializable-state contract)"
            )
        if leaf.dtype in (torch.float64, torch.complex128):
            raise TypeError(
                f"sampler-state leaf {i} has dtype {leaf.dtype}: 64-bit float leaves double "
                "checkpoint size and break bitwise resume (serializable-state dtype contract)"
            )


class SampleResult(NamedTuple):
    """Outcome of one sampling step.

    mask:      (N,) bool — client included (the union of the draws for RSP).
    counts:    (N,) int32 — number of draws of each client (RSP with
               replacement); mask as integers for ISP and RSP without.
    marginals: (N,) float — inclusion probability P(i in S).
    draw_probs:(N,) float — per-draw distribution (sums to 1) for RSP;
               marginals / K for ISP (diagnostic only).
    """

    mask: torch.Tensor
    counts: torch.Tensor
    marginals: torch.Tensor
    draw_probs: torch.Tensor

    @property
    def size(self) -> torch.Tensor:
        return self.counts.sum()


def _isp_draw(uniforms: torch.Tensor, marginals: torch.Tensor, total=None) -> SampleResult:
    """The Bernoulli draw; ``total(x)`` reduces the marginals' sum over the
    shards when they are a rank's block."""
    mask = uniforms < marginals
    msum = marginals.sum()
    return SampleResult(
        mask=mask,
        counts=mask.to(torch.int32),
        marginals=marginals,
        draw_probs=marginals / torch.clamp(msum if total is None else total(msum), min=1e-30),
    )


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) int32 number of times each client appears in ``idx`` (integer
    atomics on the card: exact and repeatable).  Not ``torch.bincount``,
    which reads the largest index back to the host on the card."""
    counts = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return counts.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.int32, device=idx.device))


def _rsp_wr_draw(uniforms: torch.Tensor, draw_probs: torch.Tensor, budget: int) -> SampleResult:
    """K draws with replacement from a normalized distribution, draw k the
    first client whose cumulative probability reaches ``total * (1 - u_k)``
    (``jax.random.choice(key, n, (K,), p=p)`` with ``u`` its uniforms).  The
    prefix sums are taken in f64 and rounded to f32, so the card and the
    CPU search the same values."""
    n = draw_probs.shape[0]
    cum = torch.cumsum(draw_probs, 0, dtype=torch.float64).to(torch.float32)
    idx = torch.searchsorted(cum, cum[-1] * (1.0 - uniforms))
    counts = _counts(idx, n)
    marginals = 1.0 - (1.0 - draw_probs) ** budget
    return SampleResult(mask=counts > 0, counts=counts, marginals=marginals, draw_probs=draw_probs)


def _rsp_wor_uniform_draw(indices: torch.Tensor, n: int, budget: int) -> SampleResult:
    """K distinct clients drawn uniformly (``indices`` from the random
    source): marginals K/N exactly."""
    counts = _counts(indices, n)
    device = indices.device
    return SampleResult(
        mask=counts > 0,
        counts=counts,
        marginals=torch.full((n,), budget / n, dtype=torch.float32, device=device),
        draw_probs=torch.full((n,), 1.0 / n, dtype=torch.float32, device=device),
    )


def draw_input(source, procedure: str, t: int, n: int, budget: int) -> torch.Tensor:
    """Round t's input of ``Sampler.sample_from`` from a random source
    (``repro_torch.rng``), by procedure: (N,) Bernoulli uniforms for ISP,
    (K,) uniforms for RSP with replacement, (K,) clients for RSP without."""
    if procedure == "isp":
        return source.isp_uniforms(t, n)
    if procedure == "rsp_wr":
        return source.rsp_uniforms(t, budget)
    if procedure == "rsp_wor":
        return source.rsp_wor_indices(t, n, budget)
    raise ValueError(f"unknown procedure {procedure!r}")


@dataclasses.dataclass
class SamplerState:
    """Generic sampler state: cumulative statistics + round counter."""

    stats: torch.Tensor  # (N,) cumulative (importance-weighted) squared feedback
    aux: torch.Tensor  # (N,) sampler-specific (K-Vib: running gamma; Avare: estimates)
    t: torch.Tensor  # 0-d int32 round counter


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base: uniform-ISP behaviour; subclasses override the hooks."""

    n: int
    budget: int
    procedure: str = "isp"  # "isp" | "rsp_wr" | "rsp_wor"
    shard: ShardSpec | None = None  # (N,)-axis shard layout (module docstring)

    @property
    def splits(self) -> bool:
        """True when the client axis is split over S > 1 ranks."""
        return self.shard is not None and self.shard.splits

    def shard_constrain(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a leading-(N,) value when the client axis is
        split (``ShardSpec.block``); ``x`` itself otherwise, or when it is
        already the block."""
        if not self.splits or x.shape[0] != self.n:
            return x
        lo, hi = self.shard.block(self.n)
        return x[lo:hi]

    def shard_state(self, state: SamplerState) -> SamplerState:
        """``shard_constrain`` over a state's (N,) leaves."""
        return dataclasses.replace(state, **{
            f.name: self.shard_constrain(getattr(state, f.name))
            for f in dataclasses.fields(state) if getattr(state, f.name).dim() >= 1
        })

    # Reductions over the whole client axis: the identity on one shard.
    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.sum(x) if self.splits else x

    def _max(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.max(x) if self.splits else x

    def _any(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.any(x) if self.splits else x

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.gather(x, self.n) if self.splits else x

    def _solve(self, scores: torch.Tensor, p_min: float = 0.0) -> torch.Tensor:
        """The water-filling solve of (a block of) the scores."""
        return solver.isp_probabilities_unchecked(
            scores, self.budget, p_min, shard=self.shard, n=self.n if self.splits else None
        )

    def init(self, device) -> SamplerState:
        return SamplerState(
            stats=torch.zeros(self.n, dtype=torch.float32, device=device),
            aux=torch.zeros(self.n, dtype=torch.float32, device=device),
            t=torch.zeros((), dtype=torch.int32, device=device),
        )

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        """Marginal inclusion probabilities (sum == budget for ISP)."""
        return torch.full(
            state.stats.shape, self.budget / self.n, dtype=torch.float32, device=state.stats.device
        )

    def sample_from(self, probs: torch.Tensor, draw_input: torch.Tensor) -> SampleResult:
        """Draw a cohort from already-solved probabilities, with the draw's
        input from the run's random source (``draw_input``, by procedure).
        On a split client axis ``probs`` is this rank's block and
        ``draw_input`` the global draw; the result is this rank's block."""
        if self.procedure == "isp":
            if self.splits:
                return _isp_draw(self.shard_constrain(draw_input), probs, self._sum)
            return _isp_draw(draw_input, probs)
        if self.procedure == "rsp_wr":
            probs = self._gather(probs)
            draw = _rsp_wr_draw(
                draw_input, probs / torch.clamp(probs.sum(), min=1e-30), self.budget
            )
        else:
            draw = _rsp_wor_uniform_draw(draw_input, self.n, self.budget)
        return SampleResult(*(self.shard_constrain(x) for x in draw)) if self.splits else draw

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        return dataclasses.replace(state, t=state.t + 1)


@dataclasses.dataclass(frozen=True)
class UniformISP(Sampler):
    """Independent Bernoulli(K/N) — the naive-ISP baseline of Section 3."""


@dataclasses.dataclass(frozen=True)
class UniformRSP(Sampler):
    """Vanilla FedAvg sampling: K uniform without replacement."""

    procedure: str = "rsp_wor"


def _g_sq(draw: SampleResult, feedback: torch.Tensor, sampler: Sampler) -> torch.Tensor:
    """G^2 of the first-round auto-gamma, G the mean observed feedback
    (paper Section 6, "FL and sampler hyperparameters"); both sums over all
    N in one ``all_reduce`` on a split client axis."""
    fb_sum = torch.where(draw.mask, feedback, 0.0).sum()
    if sampler.splits:
        sums = sampler._sum(torch.stack([fb_sum, draw.mask.sum().to(fb_sum.dtype)]))
        return (sums[0] / torch.clamp(sums[1], min=1)) ** 2
    g_est = fb_sum / torch.clamp(draw.mask.sum(), min=1)
    return g_est**2


@dataclasses.dataclass(frozen=True)
class KVib(Sampler):
    """Algorithm 2 — the paper's contribution.

    p^t from the FTRL water-filling solution on sqrt(omega + gamma)
    (Lemma 5.1), mixed with theta * K/N (eq. 12), drawn independently, and
    updated with importance-weighted squared feedback.

    Hyperparameters follow Section 6: theta = (N/(T K))^{1/3},
    gamma ~= G^2 N / (theta K) with G estimated from first-round feedback
    when ``gamma`` is left as None.
    """

    horizon: int = 500
    theta: float | None = None
    gamma: float | None = None
    p_min: float = 0.0  # optional explicit floor below the mixing floor

    def _theta(self) -> float:
        if self.theta is not None:
            return float(self.theta)
        return float(min(1.0, (self.n / (self.horizon * self.budget)) ** (1.0 / 3.0)))

    def init(self, device) -> SamplerState:
        st = super().init(device)
        # aux holds the running gamma (auto-estimated from first feedback) in
        # every slot, so the state keeps one (N,) shape.
        gamma0 = 0.0 if self.gamma is None else float(self.gamma)
        return dataclasses.replace(st, aux=torch.full_like(st.aux, gamma0))

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        gamma = torch.clamp(state.aux[0], min=1e-12)
        scores = torch.sqrt(state.stats + gamma)
        p = self._solve(scores, self.p_min)
        return solver.mix_probabilities(p, self._theta(), self.budget, self.n)

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        contrib = torch.where(
            draw.mask, feedback**2 / torch.clamp(draw.marginals, min=1e-30), 0.0
        )
        stats = state.stats + contrib
        aux = state.aux
        if self.gamma is None:
            gamma_auto = _g_sq(draw, feedback, self) * self.n / (self._theta() * self.budget)
            aux = torch.where(state.t == 0, gamma_auto.expand_as(aux), aux)
        return SamplerState(stats=stats, aux=aux, t=state.t + 1)


@dataclasses.dataclass(frozen=True)
class Vrb(Sampler):
    """Variance-Reducer-Bandit (Borsos et al., 2018), an RSP baseline: FTRL
    on the probability simplex, p_i ~ sqrt(cumulative squared feedback +
    gamma), mixed with theta-uniform, K draws with replacement."""

    procedure: str = "rsp_wr"
    horizon: int = 500
    theta: float | None = None
    gamma: float | None = None

    def _theta(self) -> float:
        if self.theta is not None:
            return float(self.theta)
        return float(min(1.0, (self.n / self.horizon) ** (1.0 / 3.0)))

    def init(self, device) -> SamplerState:
        st = super().init(device)
        gamma0 = 0.0 if self.gamma is None else float(self.gamma)
        return dataclasses.replace(st, aux=torch.full_like(st.aux, gamma0))

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        gamma = torch.clamp(state.aux[0], min=1e-12)
        w = torch.sqrt(state.stats + gamma)
        p = w / torch.clamp(self._sum(w.sum()), min=1e-30)
        theta = self._theta()
        return (1.0 - theta) * p + theta / self.n

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        # Each draw of client i adds feedback^2 / q_i (counts-aware).
        q = torch.clamp(draw.draw_probs, min=1e-30)
        contrib = draw.counts.to(feedback.dtype) * feedback**2 / q
        stats = state.stats + contrib / max(self.budget, 1)
        aux = state.aux
        if self.gamma is None:
            gamma_auto = _g_sq(draw, feedback, self) * self.n / max(self._theta(), 1e-6)
            aux = torch.where(state.t == 0, gamma_auto.expand_as(aux), aux)
        return SamplerState(stats=stats, aux=aux, t=state.t + 1)


@dataclasses.dataclass(frozen=True)
class Mabs(Sampler):
    """Multi-armed-bandit sampler (Salehi et al., 2017), EXP3-style RSP:
    multiplicative weights on importance-weighted squared feedback with
    stepsize eta, theta-uniform mixing."""

    procedure: str = "rsp_wr"
    eta: float = 0.4
    theta: float = 0.1

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        w = torch.exp(state.stats - self._max(state.stats.max()))
        p = w / torch.clamp(self._sum(w.sum()), min=1e-30)
        return (1.0 - self.theta) * p + self.theta / self.n

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        q = torch.clamp(draw.draw_probs, min=1e-30)
        # A normalized reward in [0, ~1] per draw, for EXP3's stability.
        fb2 = feedback**2
        scale = torch.clamp(self._max(torch.where(draw.mask, fb2, 0.0).max()), min=1e-30)
        reward = draw.counts.to(feedback.dtype) * (fb2 / scale) / q
        stats = state.stats + self.eta * reward / max(self.budget, 1) / self.n
        return SamplerState(stats=stats, aux=state.aux, t=state.t + 1)


@dataclasses.dataclass(frozen=True)
class Avare(Sampler):
    """Avare (El Hanchi & Stephens, 2020), an RSP baseline: the latest
    feedback of each client as its estimate (+inf until it is drawn, so
    unexplored clients get the largest estimate), sampled proportionally
    with a floor p_min_frac / N."""

    procedure: str = "rsp_wr"
    p_min_frac: float = 0.2

    def init(self, device) -> SamplerState:
        st = super().init(device)
        return dataclasses.replace(st, aux=torch.full_like(st.aux, float("inf")))

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        explored = torch.isfinite(state.aux)
        est = torch.where(explored, state.aux, 0.0)
        opt = torch.where(explored, est, self._max(torch.where(explored, est, 0.0).max()) + 1e-6)
        opt = torch.where(self._any(explored.any()), opt, torch.ones_like(opt))
        p = opt / torch.clamp(self._sum(opt.sum()), min=1e-30)
        p = torch.clamp(p, min=self.p_min_frac / self.n)
        return p / self._sum(p.sum())

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        aux = torch.where(draw.mask, feedback, state.aux)
        return SamplerState(stats=state.stats, aux=aux, t=state.t + 1)


@dataclasses.dataclass(frozen=True)
class OptimalISP(Sampler):
    """The oracle of Lemma 2.2: water-fills the last round's full feedback
    (diagnostics only; a server without full participation cannot run it)."""

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        return SamplerState(stats=feedback, aux=state.aux, t=state.t + 1)

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        p_opt = self._solve(state.stats)
        uniform = torch.full_like(p_opt, self.budget / self.n)
        return torch.where(self._any((state.stats > 0).any()), p_opt, uniform)


@dataclasses.dataclass(frozen=True)
class Osmd(Sampler):
    """OSMD-style sampler (Zhao et al. 2021, paper Appendix E.3), an RSP
    baseline: one mirror-descent step a round on the negative-entropy
    geometry (multiplicative update, then a floor p_min_frac / N and
    renormalization), the distribution itself the state."""

    procedure: str = "rsp_wr"
    lr: float = 0.5
    p_min_frac: float = 0.2

    def init(self, device) -> SamplerState:
        st = super().init(device)
        return dataclasses.replace(st, stats=torch.full_like(st.stats, 1.0 / self.n))

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        return state.stats

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        p = state.stats
        q = torch.clamp(draw.draw_probs, min=1e-30)
        # The gradient of E[pi^2 / p] at the drawn clients, importance-weighted.
        grad = -draw.counts.to(torch.float32) * feedback**2 / (q * p**2)
        grad = grad / max(self.budget, 1)
        scale = torch.clamp(self._max(grad.abs().max()), min=1e-30)
        logits = torch.log(p) - self.lr * grad / scale
        if self.splits:  # the softmax over all N: its max and sum reduced
            e = torch.exp(logits - self._max(logits.max()))
            p_new = e / self._sum(e.sum())
        else:
            p_new = torch.softmax(logits, 0)
        p_new = torch.clamp(p_new, min=self.p_min_frac / self.n)
        return SamplerState(stats=p_new / self._sum(p_new.sum()), aux=state.aux, t=state.t + 1)


@functools.lru_cache(maxsize=16)
def _cluster_layout(cluster_ids: tuple, device: torch.device):
    """The clients ordered by cluster (stable), and for each client the
    bounds of its cluster's run in that order and the cluster's size."""
    cid = np.asarray(cluster_ids, np.int64)
    order = np.argsort(cid, kind="stable")
    m = int(cid.max()) + 1
    sizes = np.bincount(cid, minlength=m)
    ends = np.cumsum(sizes)
    as_t = functools.partial(torch.as_tensor, device=device)
    return (
        as_t(order),
        as_t((ends - sizes)[cid]),
        as_t(ends[cid]),
        as_t(sizes[cid].astype(np.float32)),
    )


@dataclasses.dataclass(frozen=True)
class ClusteredKVib(Sampler):
    """Cluster-aware K-Vib (paper Section 7; cf. Fraboni et al. 2021): the
    FTRL statistics are pooled within clusters of clients (``cluster_ids``,
    values in [0, m); empty: every client alone), so a client inherits its
    cluster's feedback history before it is sampled.  The draw stays ISP."""

    cluster_ids: tuple = ()
    horizon: int = 500
    theta: float | None = None
    gamma: float | None = None

    def _theta(self) -> float:
        if self.theta is not None:
            return float(self.theta)
        return float(min(1.0, (self.n / (self.horizon * self.budget)) ** (1.0 / 3.0)))

    def init(self, device) -> SamplerState:
        st = super().init(device)
        gamma0 = 0.0 if self.gamma is None else float(self.gamma)
        return dataclasses.replace(st, aux=torch.full_like(st.aux, gamma0))

    def _cluster_mean_stats(self, stats: torch.Tensor) -> torch.Tensor:
        """Each client's cluster mean of ``stats``: a cluster's sum is the
        difference of two f64 prefix sums over the clients in cluster
        order (no float atomics, so the card repeats its bits).  On a split
        client axis the statistics are gathered whole first and the result
        is this rank's block."""
        if not self.cluster_ids:
            return stats
        stats = self._gather(stats)
        order, start, end, size = _cluster_layout(tuple(self.cluster_ids), stats.device)
        prefix = torch.cumsum(stats[order], 0, dtype=torch.float64)
        prefix = torch.cat([prefix.new_zeros(1), prefix])
        return self.shard_constrain((prefix[end] - prefix[start]).to(torch.float32) / size)

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        gamma = torch.clamp(state.aux[0], min=1e-12)
        scores = torch.sqrt(self._cluster_mean_stats(state.stats) + gamma)
        p = self._solve(scores)
        return solver.mix_probabilities(p, self._theta(), self.budget, self.n)

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        contrib = torch.where(
            draw.mask, feedback**2 / torch.clamp(draw.marginals, min=1e-30), 0.0
        )
        aux = state.aux
        if self.gamma is None:
            gamma_auto = _g_sq(draw, feedback, self) * self.n / (self._theta() * self.budget)
            aux = torch.where(state.t == 0, gamma_auto.expand_as(aux), aux)
        return SamplerState(stats=state.stats + contrib, aux=aux, t=state.t + 1)


_REGISTRY = {
    "uniform_isp": UniformISP,
    "uniform_rsp": UniformRSP,
    "kvib": KVib,
    "vrb": Vrb,
    "mabs": Mabs,
    "avare": Avare,
    "optimal_isp": OptimalISP,
    "osmd": Osmd,
    "clustered_kvib": ClusteredKVib,
}


def make_sampler(name: str, n: int, budget: int, **kw) -> Sampler:
    try:
        cls = _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown sampler {name!r}; options: {sorted(_REGISTRY)}") from e
    return cls(n=n, budget=budget, **kw)


def sampler_names() -> list[str]:
    """Registry names ``make_sampler`` accepts (and ``api.SamplerSpec.name``)."""
    return sorted(_REGISTRY)
