"""``build(spec)`` / ``run(spec)``: the port's front door over both stacks.

``build`` resolves an ``ExperimentSpec``'s registry names
(``api.spec.register_task`` / ``register_dataset``, ``configs.get_config``)
into the concrete objects a stack consumes, with the federated dataset on
the run's device; ``run`` dispatches on ``task.kind``:

* ``"task"`` — the simulation stack: ``fed.server.run_federated(task,
  dataset, sampler, fed_config)``, with any of the nine registry samplers
  (``core.sampler_names()``), in oracle and deployable modes, with an
  enabled ``fault`` section, an enabled ``compression`` section and
  ``execution.sampler_axis``;
* ``"zoo"`` — the zoo round (``fed.round.build_fed_scan_segment``) over an
  architecture of ``repro_torch.configs`` (every family; the vlm and
  audio configs build, and their run raises ``ValueError`` in round 0, as
  the reference's fails there, since the round passes no frontend
  embeddings), driven by ``fed.state.run_segmented`` like the reference's
  ``launch.train --compiled``, with the same sections.  An MoE round whose
  parameters, training copies and f32 estimate alone pass the card's memory
  (``_round_bytes``; an H100's on the CPU) raises ``NotImplementedError``:
  arctic-480b at full width, whose one layer holds 14.07e9 parameters,
  waits for expert parallelism.

Both stacks run over the run's host mesh (``_make_mesh``:
``execution.mesh_shape``, else ``launch.mesh.make_host_mesh()`` over the
default ``torch.distributed`` group).  A mesh whose data axes hold S > 1
ranks splits the client axis over them (``fed.server``, ``fed.round``): the
sampler gets a ``ShardSpec`` over those axes (or over
``execution.sampler_axis``), and every rank of a group of exactly S ranks
runs the spec.  The ranks of a ``model`` axis larger than 1 replicate
their data block's work, as the reference's ``api.run`` does (its zoo
round constrains only the batches and it enters no ``use_rules``): the
same draws, the same state; only the rank at mesh coordinate 0 writes
checkpoints (``launch.mesh.is_writer``).  ``execution.sampler_axis`` may
name any axes that cover the data axes, ``("data", "model")`` for one:
the client axis then splits over all of their ranks.  A mesh of more ranks
than the default process group holds raises ``ValueError``.  The model
axis's split step (``models/sharding.py``) runs under ``use_rules``: the
dry run and ``chip_smoke.py``'s "model_axis" phase.

Both run on the GPU unless ``device="cpu"`` is passed
(``repro_torch.device``), and both take a ``repro_torch.checkpoint``
``CheckpointManager`` whose fingerprint should be
``config_fingerprint(spec)``; ``restore_template(spec)`` is the fresh
round-0 ``TrainState`` a checkpoint of the spec restores into.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import torch

from repro_torch.api.spec import (
    ExperimentSpec,
    _dataset_registry,
    _task_registry,
    dataset_names,
    task_names,
)
from repro_torch.core import stragglers
from repro_torch.core.samplers import make_sampler
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.fed.server import FedConfig, History, build_segment_runner, run_federated
from repro_torch.fed.state import run_segmented
from repro_torch.fed.tasks import params_to_numpy, tree_map
from repro_torch.launch.mesh import (
    Mesh,
    ShardSpec,
    batch_axes,
    check_group,
    make_host_mesh,
    make_mesh,
)
from repro_torch.rng import PhiloxSource

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
    """The resolved pieces of one spec, the dataset on ``device``.

    kind="task": ``task``, ``fed_config``: exactly the ``run_federated``
    argument tuple.  kind="zoo": ``arch_config`` (``models.common.
    ArchConfig``) and ``round_spec`` (``fed.round.RoundSpec``); its ``spec``
    has ``cohort=None`` resolved to ``max(1, min(2K, N))``."""

    spec: ExperimentSpec
    kind: str
    dataset: Any
    sampler: Any
    device: Any
    task: Any = None  # kind="task"
    fed_config: FedConfig | None = None  # kind="task"
    arch_config: Any = None  # kind="zoo"
    round_spec: Any = None  # kind="zoo"


MODEL_AXIS = "see ROADMAP.md section 1, 'What is left of the model axis'"


def _make_mesh(spec: ExperimentSpec) -> Mesh:
    """The run's host mesh: ``execution.mesh_shape`` as (data, model) or
    (pod, data, model), else ``make_host_mesh()`` over the default process
    group (the reference's ``_make_mesh``).  Raises ``ValueError`` when
    the mesh holds several ranks and the default group not exactly those."""
    shape = spec.execution.mesh_shape
    mesh = make_host_mesh() if shape is None else make_mesh(shape)
    check_group(mesh, "the spec")
    return mesh


def _sampler_shard(spec: ExperimentSpec) -> ShardSpec | None:
    """The client axis's ``ShardSpec`` over the run's mesh, or None.

    ``execution.sampler_axis`` names its axis; without one the axis is the
    mesh's data axes (``batch_axes``), and None (the whole axis on every
    rank) when they hold one rank.  One shard of a named axis is
    ``ShardSpec(((axis, 1),), axis)``.  Raises ``ValueError`` when the axis
    holds S > 1 ranks and the default process group does not hold exactly
    the mesh's (``ShardSpec.process_group``), or when the named axes do not
    cover the mesh's data axes."""
    mesh = _make_mesh(spec)
    baxes = batch_axes(mesh)
    data = ShardSpec.from_mesh(mesh, axis=baxes[0] if len(baxes) == 1 else baxes)
    axis = spec.execution.sampler_axis
    shard = data if axis is None else ShardSpec.from_mesh(mesh, axis=axis)
    named = (axis,) if isinstance(axis, str) else tuple(axis or baxes)
    missing = [a for a in baxes if mesh.shape[a] > 1 and a not in named]
    if missing:
        raise ValueError(
            f"execution.sampler_axis={axis!r} leaves the data axes {missing} of the mesh "
            f"{mesh.shape} out: the client axis splits over every rank of them"
        )
    if not shard.splits:
        return None if axis is None else ShardSpec(axes=tuple((a, 1) for a in named), axis=axis)
    shard.process_group()  # no rank runs the spec unsplit without its group
    return shard


def _make_sampler(spec: ExperimentSpec, n_clients: int):
    return make_sampler(
        spec.sampler.name,
        n=n_clients,
        budget=spec.federation.budget,
        shard=_sampler_shard(spec),
        **dict(spec.sampler.kwargs),
    )


def _check_dataset(spec: ExperimentSpec) -> None:
    if spec.task.dataset not in _dataset_registry():
        raise ValueError(
            f"unknown dataset {spec.task.dataset!r}; registered: {dataset_names()} "
            "(repro_torch.api.register_dataset adds custom factories)"
        )


def _build_task(spec: ExperimentSpec, dev) -> BuiltExperiment:
    tasks = _task_registry()
    if spec.task.name not in tasks:
        raise ValueError(
            f"unknown task {spec.task.name!r}; registered: {task_names()} "
            "(repro_torch.api.register_task adds custom factories)"
        )
    _check_dataset(spec)
    task = tasks[spec.task.name](**dict(spec.task.kwargs))
    ds = _build_dataset(
        spec.task.dataset, _dataset_registry()[spec.task.dataset],
        dict(spec.task.dataset_kwargs), dev,
    )
    return BuiltExperiment(
        spec=spec,
        kind="task",
        dataset=ds,
        sampler=_make_sampler(spec, ds.n_clients),
        device=dev,
        task=task,
        fed_config=spec.fed_config(),
    )


# An H100's memory: the card the zoo round is sized for when it is built
# for the CPU.
H100_BYTES = 80 * 2**30


def _card_bytes(dev: torch.device) -> int:
    """The memory of the card ``dev``, or an H100's on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return H100_BYTES


def _round_bytes(cfg, cohort: int) -> int:
    """A lower bound of a zoo round's resident bytes: the global parameters,
    each training copy with its gradients (C at once in ``client_parallel``,
    one at a time in ``cohort_sequential``) and the f32 estimate or
    accumulator; activations not counted.  From the shapes alone (the
    ``meta`` device)."""
    from repro_torch.models import transformer

    n = transformer.param_count(transformer._init_tree(cfg, None))
    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    copies = cohort if cfg.round_mode == "client_parallel" else 1
    return n * (item * (1 + 2 * copies) + 4)


def _build_zoo(spec: ExperimentSpec, dev) -> BuiltExperiment:
    from repro_torch.configs import get_config, has_arch, list_archs

    if not has_arch(spec.task.name):
        raise ValueError(f"unknown zoo arch {spec.task.name!r}; options: {list_archs()}")
    cfg = get_config(spec.task.name)
    if spec.task.reduced:
        cfg = cfg.reduced(**dict(spec.task.kwargs))
    _check_dataset(spec)
    ds_kw = dict(spec.task.dataset_kwargs)
    if spec.task.dataset == "synthetic_tokens":
        # The reference launcher's defaults: vocab from the arch, seed from
        # the run seed, total_seqs sized to the client count.
        ds_kw.setdefault("vocab", cfg.vocab)
        ds_kw.setdefault("seed", spec.execution.seed)
        if "n_clients" in ds_kw:
            ds_kw.setdefault("total_seqs", max(32 * int(ds_kw["n_clients"]), 512))
    ds = _build_dataset(spec.task.dataset, _dataset_registry()[spec.task.dataset], ds_kw, dev)
    fed = spec.federation
    if fed.cohort is None:
        fed = dataclasses.replace(fed, cohort=max(1, min(2 * fed.budget, ds.n_clients)))
        spec = dataclasses.replace(spec, federation=fed)
    if cfg.n_experts:
        need, card = _round_bytes(cfg, int(fed.cohort)), _card_bytes(torch.device(dev))
        if need > card:
            raise NotImplementedError(
                f"the zoo round of {cfg.name} holds at least {need / 1e9:.1f} GB "
                f"(parameters, training copies with their gradients, the f32 estimate), "
                f"more than the card's {card / 1e9:.1f} GB; it needs its experts sharded "
                f"over several cards: {MODEL_AXIS}"
            )
    return BuiltExperiment(
        spec=spec,
        kind="zoo",
        dataset=ds,
        sampler=_make_sampler(spec, ds.n_clients),
        device=dev,
        arch_config=cfg,
        round_spec=spec.round_spec(),
    )


def build(spec: ExperimentSpec, device=None) -> BuiltExperiment:
    """Resolve a spec into the concrete experiment objects on ``device``."""
    dev = resolve_device(device)
    if spec.task.kind == "zoo":
        return _build_zoo(spec, dev)
    return _build_task(spec, dev)


def _specs_compatible(a: ExperimentSpec, b: ExperimentSpec) -> bool:
    """Equality modulo the one build-time resolution: ``cohort=None`` may
    have been replaced by its concrete default in a built spec."""
    fa, fb = a.federation, b.federation
    if fa.cohort is None or fb.cohort is None:
        fa = dataclasses.replace(fa, cohort=None)
        fb = dataclasses.replace(fb, cohort=None)
    return (a.task, a.sampler, fa, a.execution, a.fault, a.compression, a.serve) == (
        b.task, b.sampler, fb, b.execution, b.fault, b.compression, b.serve,
    )


def _built_for(spec: ExperimentSpec, device, built: BuiltExperiment | None) -> BuiltExperiment:
    dev = resolve_device(device)
    if built is None:
        return build(spec, dev)
    if not _specs_compatible(built.spec, spec) or built.device != dev:
        raise ValueError("run(built=...) got a BuiltExperiment from a different spec or device")
    return built


def _zoo_segment_and_state(built: BuiltExperiment, random_source=None):
    """(segment_fn, round-0 TrainState) of the zoo round.  The parameters
    are ``models.transformer.init_params`` drawn from the random source's
    init stream (default: ``PhiloxSource`` seeded with ``execution.seed``),
    or a replayed source's recorded weights."""
    from repro_torch.fed.round import ZooModel, build_fed_scan_segment

    spec, dev = built.spec, built.device
    source = PhiloxSource(spec.execution.seed, dev) if random_source is None else random_source
    params = source.init_params(ZooModel(built.arch_config))
    segment, make_state = build_fed_scan_segment(
        built.arch_config, built.round_spec, built.sampler, built.dataset, source=source,
        device=dev,
    )
    return segment, make_state(params, built.sampler.init(dev), spec.federation.rounds)


def _run_zoo(built: BuiltExperiment, ckpt_manager, publish, random_source) -> History:
    spec = built.spec
    t0 = time.perf_counter()
    ckpt_every = spec.execution.ckpt_every
    if ckpt_manager is not None and ckpt_every <= 0:
        raise ValueError(
            "run(spec, ckpt_manager=...) needs execution.ckpt_every > 0; "
            f"got ckpt_every={ckpt_every}"
        )
    segment, state = _zoo_segment_and_state(built, random_source)
    if ckpt_manager is not None:
        state, _ = ckpt_manager.restore_or_init(state)
    rounds = spec.federation.rounds
    state = run_segmented(
        state, rounds, segment, ckpt_every=ckpt_every, manager=ckpt_manager, publish=publish
    )
    params = state.params
    fault = spec.fault
    if fault.enabled and int(fault.async_buffer) > 0:
        # End-of-horizon flush of the still-pending stale deltas (segment
        # boundaries keep the ring in the carry).
        buf = state.faults["buf"]
        if bool(buf["valid"].any()):
            pending = stragglers.flush_pending(buf, rounds, float(fault.staleness_discount))
            d_pend = stragglers.vec_to_tree(pending, params)
            params = tree_map(lambda p, g: p - g, params, d_pend)
    metrics = {k: b.cpu().numpy() for k, b in state.metrics.items()}
    hist = History()
    hist.rounds = list(range(rounds))
    hist.train_loss = [float(x) for x in metrics["loss"]]
    hist.cohort_size = [int(x) for x in metrics["cohort_size"]]
    hist.cohort_dropped = [int(x) for x in metrics["dropped"]]
    if "deadline_dropped" in metrics:
        hist.deadline_dropped = [int(x) for x in metrics["deadline_dropped"]]
    hist.final_params = params_to_numpy(params)
    hist.wall_time_s = time.perf_counter() - t0
    return hist


def run(
    spec: ExperimentSpec,
    device=None,
    *,
    eval_data: tuple | None = None,
    built: BuiltExperiment | None = None,
    random_source=None,
    ckpt_manager=None,
    publish=None,
) -> History:
    """Execute a spec end to end on ``device`` (default: the GPU).

    ``eval_data`` — optional (x, y) evaluation batch for the accuracy curve
    (simulation stack only).
    ``built`` — a prior ``build(spec, device)`` result to reuse (its spec
    may have ``cohort`` resolved).
    ``random_source`` — every draw of the run (``repro_torch.rng``); default
    Philox generators seeded from ``spec.execution.seed``.
    ``ckpt_manager`` — a ``repro_torch.checkpoint.CheckpointManager``:
    restore the latest committed state, then publish one at every
    ``execution.ckpt_every`` boundary; the sampler's ``ShardSpec`` is
    recorded as its ``layout`` (provenance only).
    ``publish`` — ``(state, rounds_done)`` callback fired after each
    boundary's manifest commit (zoo stack; needs ``ckpt_manager``): the
    train side of a serving hand-off."""
    built = _built_for(spec, device, built)
    if ckpt_manager is not None and getattr(ckpt_manager, "layout", None) is None:
        ckpt_manager.layout = built.sampler.shard
    if built.kind == "zoo":
        if eval_data is not None:
            raise ValueError(
                "eval_data is only supported on the simulation stack "
                "(kind='task'); the zoo stack's metrics are train loss / "
                "cohort size / drops"
            )
        return _run_zoo(built, ckpt_manager, publish, random_source)
    if publish is not None:
        raise ValueError(
            "run(spec, publish=...) is a zoo-stack feature (kind='zoo'): "
            "the serve hand-off follows the segmented TrainState manager"
        )
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
    into (``CheckpointManager.restore(template)``), for either stack, the
    simulation stack's without eval data.  ``run(spec, ckpt_manager=...)``
    builds the same one internally."""
    built = _built_for(spec, device, built)
    if built.kind == "zoo":
        return _zoo_segment_and_state(built)[1]
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
