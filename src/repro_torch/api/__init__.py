"""Declarative experiment API: one ``ExperimentSpec``, one ``run``::

    from repro_torch import api

    spec = api.ExperimentSpec.load("experiment.json")  # same JSON as repro.api
    history = api.run(spec)                 # on the GPU
    history = api.run(spec, device="cpu")   # plain PyTorch path
"""
from repro_torch.api.runner import BuiltExperiment, build, dataset_names, run, task_names
from repro_torch.api.spec import (
    CompressionSpec,
    ExecutionSpec,
    ExperimentSpec,
    FaultSpec,
    FederationSpec,
    SamplerSpec,
    ServeSpec,
    TaskSpec,
    server_opt_names,
)

__all__ = [
    "ExperimentSpec",
    "TaskSpec",
    "SamplerSpec",
    "FederationSpec",
    "ExecutionSpec",
    "FaultSpec",
    "CompressionSpec",
    "ServeSpec",
    "BuiltExperiment",
    "build",
    "run",
    "task_names",
    "dataset_names",
    "server_opt_names",
]
