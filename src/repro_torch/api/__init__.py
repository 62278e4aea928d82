"""Declarative experiment API: one ``ExperimentSpec``, one ``run``::

    from repro_torch import api

    spec = api.ExperimentSpec.load("experiment.json")  # same JSON as repro.api
    history = api.run(spec)                 # on the GPU
    history = api.run(spec, device="cpu")   # plain PyTorch path

``register_task`` / ``register_dataset`` add factories to the spec
registries; ``run(spec, ckpt_manager=...)`` checkpoints and resumes a run,
``restore_template(spec)`` is the state a checkpoint restores into, and
``lint(spec)`` checks the spec's traced program without training it.
"""
from repro_torch.api.runner import BuiltExperiment, build, restore_template, run
from repro_torch.api.spec import (
    CompressionSpec,
    ExecutionSpec,
    ExperimentSpec,
    FaultSpec,
    FederationSpec,
    SamplerSpec,
    ServeSpec,
    TaskSpec,
    dataset_names,
    register_dataset,
    register_task,
    server_opt_names,
    task_names,
)



def lint(spec, **kwargs):
    """Statically lint a spec's traced program (width / scan-safety / dtype
    / compile-once contracts) without training it: forwards to
    ``repro_torch.analysis.lint.run_suite`` (imported when called) and
    returns its ``LintReport``."""
    from repro_torch.analysis.lint import run_suite

    return run_suite(spec, **kwargs)


__all__ = [
    "lint",
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
    "restore_template",
    "register_task",
    "register_dataset",
    "task_names",
    "dataset_names",
    "server_opt_names",
]
