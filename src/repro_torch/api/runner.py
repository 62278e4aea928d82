"""``build(spec)`` / ``run(spec)``: the port's front door.

``build`` resolves an ``ExperimentSpec``'s registry names
(``api.spec.register_task`` / ``register_dataset``) into the task, the
federated dataset (on the run's device), the sampler and the ``FedConfig``;
``run`` calls ``fed.server.run_federated`` with them.  Both run on the GPU
unless ``device="cpu"`` is passed (``repro_torch.device``).

Served: ``kind="task"`` with any of the nine registry samplers
(``core.sampler_names()``), in oracle and deployable modes, with any of an
enabled ``fault`` section, an enabled ``compression`` section and
``execution.sampler_axis``, and with a ``repro_torch.checkpoint``
``CheckpointManager`` whose fingerprint should be
``config_fingerprint(spec)``; ``restore_template(spec)`` is the fresh
round-0 ``TrainState`` a checkpoint of the spec restores into.  Not ported
(``NotImplementedError``, naming the ``ROADMAP.md`` item): ``kind="zoo"``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.api.spec import (
    ExperimentSpec,
    _dataset_registry,
    _task_registry,
    dataset_names,
    task_names,
)
from repro_torch.core.samplers import make_sampler
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.fed.server import FedConfig, History, build_segment_runner, run_federated
from repro_torch.launch.mesh import ShardSpec

__all__ = ["BuiltExperiment", "build", "run", "restore_template"]

# Dataset construction is memoized per process and device, as in the
# reference: sweeps (budget grids, sampler panels) re-reference the same
# (factory, kwargs) cell, and factories are pure functions of their kwargs
# (the register_dataset contract).  A factory re-registered under the same
# name is another object and misses the cache.
_DATASET_CACHE: dict = {}
_DATASET_CACHE_MAX = 4


def _build_dataset(name: str, factory, kwargs: dict, device) -> FederatedDataset:
    key = (name, id(factory), json.dumps(kwargs, sort_keys=True, default=repr), str(device))
    if key not in _DATASET_CACHE:
        ds = factory(**kwargs)
        if not isinstance(ds, FederatedDataset):
            raise TypeError(
                f"dataset factory {name!r} returned {type(ds).__name__}, not a "
                "repro_torch.data.FederatedDataset"
            )
        if len(_DATASET_CACHE) >= _DATASET_CACHE_MAX:
            _DATASET_CACHE.pop(next(iter(_DATASET_CACHE)))
        _DATASET_CACHE[key] = ds.to(device)
    return _DATASET_CACHE[key]


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
    tasks, datasets = _task_registry(), _dataset_registry()
    if spec.task.name not in tasks:
        raise ValueError(
            f"unknown task {spec.task.name!r}; registered: {task_names()} "
            "(repro_torch.api.register_task adds custom factories)"
        )
    if spec.task.dataset not in datasets:
        raise ValueError(
            f"unknown dataset {spec.task.dataset!r}; registered: {dataset_names()} "
            "(repro_torch.api.register_dataset adds custom factories)"
        )
    task = tasks[spec.task.name](**dict(spec.task.kwargs))
    ds = _build_dataset(
        spec.task.dataset, datasets[spec.task.dataset], dict(spec.task.dataset_kwargs), dev
    )
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


def _built_for(spec: ExperimentSpec, device, built: BuiltExperiment | None) -> BuiltExperiment:
    dev = resolve_device(device)
    if built is None:
        return build(spec, dev)
    if built.spec != spec or built.device != dev:
        raise ValueError("run(built=...) got a BuiltExperiment from a different spec or device")
    return built


def run(
    spec: ExperimentSpec,
    device=None,
    *,
    eval_data: tuple | None = None,
    built: BuiltExperiment | None = None,
    random_source=None,
    ckpt_manager=None,
) -> History:
    """Execute a spec end to end on ``device`` (default: the GPU).

    ``eval_data`` — optional (x, y) evaluation batch for the accuracy curve.
    ``built`` — a prior ``build(spec, device)`` result to reuse.
    ``random_source`` — every draw of the run (``repro_torch.rng``); default
    Philox generators seeded from ``spec.execution.seed``.
    ``ckpt_manager`` — a ``repro_torch.checkpoint.CheckpointManager``:
    restore the latest committed state, then publish one at every
    ``execution.ckpt_every`` boundary; the sampler's ``ShardSpec`` is
    recorded as its ``layout`` (provenance only)."""
    built = _built_for(spec, device, built)
    if ckpt_manager is not None and getattr(ckpt_manager, "layout", None) is None:
        ckpt_manager.layout = built.sampler.shard
    return run_federated(
        built.task,
        built.dataset,
        built.sampler,
        built.fed_config,
        eval_data=eval_data,
        device=built.device,
        random_source=random_source,
        ckpt_manager=ckpt_manager,
    )


def restore_template(spec: ExperimentSpec, *, built: BuiltExperiment | None = None, device=None):
    """The fresh round-0 ``TrainState`` a checkpoint of this spec restores
    into (``CheckpointManager.restore(template)``), without eval data.
    ``run(spec, ckpt_manager=...)`` builds the same one internally."""
    built = _built_for(spec, device, built)
    cfg = built.fed_config
    if not cfg.compiled:
        raise ValueError(
            "restore templates exist only for the compiled execution path "
            "(execution.compiled=False has no checkpointable TrainState)"
        )
    _, state = build_segment_runner(
        built.task, built.dataset, built.sampler, cfg, device=built.device
    )
    return state
