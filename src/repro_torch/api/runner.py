"""``build(spec)`` / ``run(spec)``: the port's front door.

``build`` resolves an ``ExperimentSpec``'s registry names into the task,
the federated dataset (on the run's device), the sampler and the
``FedConfig``; ``run`` calls ``fed.server.run_federated`` with them.  Both
run on the GPU unless ``device="cpu"`` is passed (``repro_torch.device``).

Served: ``kind="task"`` with any of the nine registry samplers
(``core.sampler_names()``), in oracle and deployable modes, with any of an
enabled ``fault`` section, an enabled ``compression`` section and
``execution.sampler_axis``.  Not ported
(``NotImplementedError``, naming the ``ROADMAP.md`` item): ``kind="zoo"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.samplers import make_sampler
from repro_torch.data import synthetic_classification, synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.fed import tasks
from repro_torch.fed.server import FedConfig, History, run_federated
from repro_torch.launch.mesh import ShardSpec

__all__ = ["BuiltExperiment", "build", "run", "task_names", "dataset_names"]

_TASKS = {
    "logreg": tasks.logistic_regression,
    "mlp": tasks.mlp_classifier,
    "tiny_lm": tasks.tiny_lm,
}
_DATASETS = {
    "synthetic_classification": synthetic_classification,
    "synthetic_tokens": synthetic_tokens,
}


def task_names() -> list[str]:
    return sorted(_TASKS)


def dataset_names() -> list[str]:
    return sorted(_DATASETS)


@dataclasses.dataclass(frozen=True)
class BuiltExperiment:
    """The resolved pieces of one ``kind="task"`` spec: exactly the
    ``run_federated`` argument tuple, with the dataset on ``device``."""

    spec: ExperimentSpec
    kind: str
    dataset: Any
    sampler: Any
    task: Any
    fed_config: FedConfig
    device: Any


def _check_ported(spec: ExperimentSpec) -> None:
    if spec.task.kind == "zoo":
        raise NotImplementedError(
            "kind='zoo' is not ported to repro_torch yet; see ROADMAP.md "
            "queue 1, 'Zoo models + pod-scale round'"
        )


def _sampler_shard(spec: ExperimentSpec) -> ShardSpec | None:
    """The ``ShardSpec`` that ``spec.execution.sampler_axis`` denotes, or
    None: the axis over the ranks of the default process group, one shard
    when ``torch.distributed`` is not initialised.  Only the K-Vib solve is
    split; every rank runs the rest of the round on the whole (N,) state."""
    axis = spec.execution.sampler_axis
    return None if axis is None else ShardSpec.from_process_group(axis)


def build(spec: ExperimentSpec, device=None) -> BuiltExperiment:
    """Resolve a spec into the concrete experiment objects on ``device``."""
    _check_ported(spec)
    dev = resolve_device(device)
    if spec.task.name not in _TASKS:
        raise ValueError(f"unknown task {spec.task.name!r}; registered: {task_names()}")
    if spec.task.dataset not in _DATASETS:
        raise ValueError(
            f"unknown dataset {spec.task.dataset!r}; registered: {dataset_names()}"
        )
    task = _TASKS[spec.task.name](**dict(spec.task.kwargs))
    ds = _DATASETS[spec.task.dataset](**dict(spec.task.dataset_kwargs), device=dev)
    sampler = make_sampler(
        spec.sampler.name,
        n=ds.n_clients,
        budget=spec.federation.budget,
        shard=_sampler_shard(spec),
        **dict(spec.sampler.kwargs),
    )
    return BuiltExperiment(
        spec=spec,
        kind="task",
        dataset=ds,
        sampler=sampler,
        task=task,
        fed_config=spec.fed_config(),
        device=dev,
    )


def run(
    spec: ExperimentSpec,
    device=None,
    *,
    eval_data: tuple | None = None,
    built: BuiltExperiment | None = None,
    random_source=None,
) -> History:
    """Execute a spec end to end on ``device`` (default: the GPU).

    ``eval_data`` — optional (x, y) evaluation batch for the accuracy curve.
    ``built`` — a prior ``build(spec, device)`` result to reuse.
    ``random_source`` — every draw of the run (``repro_torch.rng``); default
    Philox generators seeded from ``spec.execution.seed``."""
    dev = resolve_device(device)
    if built is None:
        built = build(spec, dev)
    elif built.spec != spec or built.device != dev:
        raise ValueError("run(built=...) got a BuiltExperiment from a different spec or device")
    return run_federated(
        built.task,
        built.dataset,
        built.sampler,
        built.fed_config,
        eval_data=eval_data,
        device=dev,
        random_source=random_source,
    )
