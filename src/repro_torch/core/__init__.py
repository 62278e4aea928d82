from repro_torch.core import estimator, regret, samplers, solver
from repro_torch.core.regret import RegretTracker, round_costs
from repro_torch.core.samplers import (
    KVib,
    SampleResult,
    Sampler,
    SamplerState,
    UniformISP,
    make_sampler,
    sampler_names,
)

__all__ = [
    "estimator",
    "regret",
    "samplers",
    "solver",
    "RegretTracker",
    "round_costs",
    "KVib",
    "SampleResult",
    "Sampler",
    "SamplerState",
    "UniformISP",
    "make_sampler",
    "sampler_names",
]
