"""Client samplers: K-Vib (Algorithm 2) and the uniform ISP baseline.

Port of ``repro/core/samplers.py``.  A sampler is a frozen configuration
object with pure functions over an explicit state::

    sampler = KVib(n=N, budget=K, horizon=T)
    state   = sampler.init(device)
    probs   = sampler.probabilities(state)          # marginal inclusion probs
    draw    = sampler.sample_from(probs, uniforms)  # SampleResult
    state   = sampler.update(state, draw, feedback)

``feedback`` is the paper's ``pi_t(i) = lambda_i * ||g_i^t||`` for the
clients in the cohort (zeros elsewhere); the importance correction by the
sampling probability happens inside ``update``.

Randomness is injected: ``sample_from`` takes the (N,) uniforms of the
independent Bernoulli draw from the run's random source
(``repro_torch.rng``) instead of a key, so a test can replay the
reference's own draws.  Every state field is a tensor on the run's device
(the round counter included), so a round never reads the device from the
host.

With ``shard=ShardSpec(...)`` (``launch.mesh``) K-Vib's water-filling
solve runs split over the layout's process group
(``solver.isp_probabilities(..., shard=...)``).  The reference also pins
every (N,) value to the shard layout (``shard_constrain`` /
``shard_state``); the port places nothing, so those hooks are identities
here, and every rank holds the whole (N,) state.

Only ``uniform_isp`` and ``kvib`` are ported; ``make_sampler`` raises
``NotImplementedError`` for the reference's other registry names.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import solver
from repro_torch.launch.mesh import ShardSpec

__all__ = [
    "SampleResult",
    "SamplerState",
    "Sampler",
    "UniformISP",
    "KVib",
    "make_sampler",
    "sampler_names",
]


class SampleResult(NamedTuple):
    """Outcome of one sampling step.

    mask:      (N,) bool — client included.
    counts:    (N,) int32 — mask as integers (ISP draws each client once).
    marginals: (N,) float — inclusion probability P(i in S).
    draw_probs:(N,) float — marginals / K (diagnostic only for ISP).
    """

    mask: torch.Tensor
    counts: torch.Tensor
    marginals: torch.Tensor
    draw_probs: torch.Tensor

    @property
    def size(self) -> torch.Tensor:
        return self.counts.sum()


def _isp_draw(uniforms: torch.Tensor, marginals: torch.Tensor) -> SampleResult:
    mask = uniforms < marginals
    return SampleResult(
        mask=mask,
        counts=mask.to(torch.int32),
        marginals=marginals,
        draw_probs=marginals / torch.clamp(marginals.sum(), min=1e-30),
    )


@dataclasses.dataclass
class SamplerState:
    """Generic sampler state: cumulative statistics + round counter."""

    stats: torch.Tensor  # (N,) cumulative (importance-weighted) squared feedback
    aux: torch.Tensor  # (N,) sampler-specific (K-Vib: running gamma)
    t: torch.Tensor  # 0-d int32 round counter


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base: uniform-ISP behaviour; subclasses override the hooks."""

    n: int
    budget: int
    procedure: str = "isp"
    shard: ShardSpec | None = None  # (N,)-axis shard layout (module docstring)

    def shard_constrain(self, x: torch.Tensor) -> torch.Tensor:
        """The reference pins a leading-(N,) value to the shard layout here;
        the port places no tensor, so this is the identity."""
        return x

    def shard_state(self, state: SamplerState) -> SamplerState:
        """``shard_constrain`` over a state's (N,) leaves: the identity."""
        return state

    def init(self, device) -> SamplerState:
        return SamplerState(
            stats=torch.zeros(self.n, dtype=torch.float32, device=device),
            aux=torch.zeros(self.n, dtype=torch.float32, device=device),
            t=torch.zeros((), dtype=torch.int32, device=device),
        )

    def probabilities(self, state: SamplerState) -> torch.Tensor:
        """Marginal inclusion probabilities (sum == budget for ISP)."""
        return torch.full(
            (self.n,), self.budget / self.n, dtype=torch.float32, device=state.stats.device
        )

    def sample_from(self, probs: torch.Tensor, uniforms: torch.Tensor) -> SampleResult:
        """Independent Bernoulli draw from already-solved probabilities, with
        the (N,) uniforms taken from the run's random source."""
        return _isp_draw(uniforms, probs)

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        return dataclasses.replace(state, t=state.t + 1)


@dataclasses.dataclass(frozen=True)
class UniformISP(Sampler):
    """Independent Bernoulli(K/N) — the naive-ISP baseline of Section 3."""


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
        p = solver.isp_probabilities_unchecked(
            scores, self.budget, self.p_min, shard=self.shard
        )
        return solver.mix_probabilities(p, self._theta(), self.budget)

    def update(
        self, state: SamplerState, draw: SampleResult, feedback: torch.Tensor
    ) -> SamplerState:
        contrib = torch.where(
            draw.mask, feedback**2 / torch.clamp(draw.marginals, min=1e-30), 0.0
        )
        stats = state.stats + contrib
        aux = state.aux
        if self.gamma is None:
            # First-round auto-gamma: G ~ mean of observed feedback (paper
            # Section 6 "FL and sampler hyperparameters").
            g_est = torch.where(draw.mask, feedback, 0.0).sum() / torch.clamp(
                draw.mask.sum(), min=1
            )
            gamma_auto = g_est**2 * self.n / (self._theta() * self.budget)
            aux = torch.where(state.t == 0, gamma_auto.expand_as(aux), aux)
        return SamplerState(stats=stats, aux=aux, t=state.t + 1)


_REGISTRY = {"uniform_isp": UniformISP, "kvib": KVib}
# The reference's other samplers; each waits for its slice (ROADMAP.md).
_NOT_PORTED = (
    "avare", "clustered_kvib", "mabs", "optimal_isp", "osmd", "uniform_rsp", "vrb",
)


def make_sampler(name: str, n: int, budget: int, **kw) -> Sampler:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"sampler {name!r} is not ported to repro_torch yet; see ROADMAP.md "
            "queue 1, 'Samplers' (ported: " + ", ".join(sorted(_REGISTRY)) + ")"
        )
    try:
        cls = _REGISTRY[name]
    except KeyError as e:
        raise ValueError(
            f"unknown sampler {name!r}; options: {sorted(_REGISTRY)}"
        ) from e
    return cls(n=n, budget=budget, **kw)


def sampler_names() -> list[str]:
    """Registry names ``make_sampler`` accepts."""
    return sorted(_REGISTRY)
