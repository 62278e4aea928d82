"""The declarative experiment description: ``ExperimentSpec``.

The port's own copy of ``repro/api/spec.py``'s dataclasses: that module
imports the JAX server, so the port cannot import it.  The copy reads the
same JSON (every section, ``fault``, ``compression`` and ``serve`` included),
rejects unknown keys the same way, and round-trips ``to_dict`` identically,
so a spec saved by either package loads in the other unchanged.  The
``serve`` section sets the geometry and gate policy of the serving loop
(``repro_torch.serve``, ``launch.serve --follow``).

Serialization contract (as in the reference):

* ``spec -> to_dict() -> json -> from_dict()`` is the identity;
* unknown keys are REJECTED with an error naming the bad field and section;
* free-form ``kwargs`` mappings pass through verbatim.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Mapping

import torch

from repro_torch.core.stragglers import deadline_survival
from repro_torch.fed.server import FedConfig
from repro_torch.optim.fedopt import FedAdam, FedAvgServer, ServerOptimizer

__all__ = [
    "TaskSpec",
    "SamplerSpec",
    "FederationSpec",
    "ExecutionSpec",
    "FaultSpec",
    "CompressionSpec",
    "ServeSpec",
    "ExperimentSpec",
    "register_task",
    "register_dataset",
    "task_names",
    "dataset_names",
    "server_opt_names",
]


# ---------------------------------------------------------------------------
# Component registries: name -> factory, as in the reference.  The built-in
# entries cover the paper experiments; ``register_task`` /
# ``register_dataset`` add scenario-specific factories
# (``repro_torch.examples.femnist_style`` registers its vision-like
# generator) while the spec stays a plain name + kwargs record.  A dataset
# factory returns a ``FederatedDataset`` on any device; the build layer
# moves it to the run's device.
# ---------------------------------------------------------------------------

_TASKS: dict = {}
_DATASETS: dict = {}


def _builtin_tasks() -> dict:
    from repro_torch.fed import tasks

    return {
        "logreg": tasks.logistic_regression,
        "mlp": tasks.mlp_classifier,
        "tiny_lm": tasks.tiny_lm,
    }


def _builtin_datasets() -> dict:
    from repro_torch.data import synthetic_classification, synthetic_tokens

    # Built on the CPU (numpy first in any case); the runner moves them.
    return {
        "synthetic_classification": functools.partial(synthetic_classification, device="cpu"),
        "synthetic_tokens": functools.partial(synthetic_tokens, device="cpu"),
    }


def _task_registry() -> dict:
    if not _TASKS:
        _TASKS.update(_builtin_tasks())
    return _TASKS


def _dataset_registry() -> dict:
    if not _DATASETS:
        _DATASETS.update(_builtin_datasets())
    return _DATASETS


def register_task(name: str, factory) -> None:
    """Register a ``Task`` factory under ``name`` for ``TaskSpec.name``.

    The factory is called with ``TaskSpec.kwargs``.  Registration is additive
    process state: a spec referencing a custom name deserializes fine but can
    only be *built* in a process that registered the factory."""
    _task_registry()[str(name)] = factory


def register_dataset(name: str, factory) -> None:
    """Register a dataset factory under ``name`` for ``TaskSpec.dataset``.

    Factories must be deterministic pure functions of their kwargs (seed
    included in the kwargs) returning a ``repro_torch.data.FederatedDataset``:
    the build layer memoizes construction per process and device, so sweeps
    that re-reference the same (dataset, kwargs) cell share one dataset."""
    _dataset_registry()[str(name)] = factory


def task_names() -> list[str]:
    return sorted(_task_registry())


def dataset_names() -> list[str]:
    return sorted(_dataset_registry())


_SERVER_OPTS: dict[str, type[ServerOptimizer]] = {
    "fedavg": FedAvgServer,
    "fedadam": FedAdam,
}


def server_opt_names() -> list[str]:
    return sorted(_SERVER_OPTS)


# ---------------------------------------------------------------------------
# Normalization helpers: JSON has no tuples, so every sequence inside a spec
# is normalized to a tuple (and every mapping to a plain dict) at
# construction time — ``from_dict(json.loads(to_json()))`` is then the
# identity, not merely an approximation.
# ---------------------------------------------------------------------------


def _normalize(value):
    if isinstance(value, Mapping):
        return {str(k): _normalize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return tuple(_normalize(v) for v in value)
    return value


def _jsonable(value):
    """The inverse direction: tuples -> lists for JSON emission."""
    if isinstance(value, Mapping):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return [_jsonable(v) for v in value]
    return value


def _from_section(cls, section: str, data: Any):
    """Instantiate a spec dataclass from a dict, rejecting unknown keys with
    an error that names the bad field and where it was found."""
    if not isinstance(data, Mapping):
        raise ValueError(
            f"spec section {section!r} must be a mapping, got {type(data).__name__}"
        )
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - fields)
    if unknown:
        raise ValueError(
            f"unknown field {unknown[0]!r} in spec section {section!r} "
            f"(valid fields: {sorted(fields)})"
        )
    return cls(**dict(data))


# ---------------------------------------------------------------------------
# The spec dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """What to train and on which federated data.

    kind:
        ``"task"`` — a simulation-scale ``repro_torch.fed.tasks.Task`` resolved
        from the task registry (``name`` + ``kwargs``); runs through
        ``repro_torch.fed.server.run_federated``.
        ``"zoo"`` — an architecture from ``repro_torch.configs`` (``name``
        is the registry arch name, ``reduced``/``kwargs`` configure
        ``ArchConfig.reduced(**kwargs)``); runs through the zoo round
        (``repro_torch.fed.round.build_fed_scan_segment``).
    dataset / dataset_kwargs:
        Dataset factory name (dataset registry) and its kwargs.  For zoo
        archs, ``vocab``, ``seed``, and ``total_seqs`` default from the arch
        config and execution seed at build time when omitted.
    """

    kind: str = "task"  # "task" | "zoo"
    name: str = "logreg"
    kwargs: dict = dataclasses.field(default_factory=dict)
    reduced: bool = False  # zoo only: start from ArchConfig.reduced()
    dataset: str = "synthetic_classification"
    dataset_kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in ("task", "zoo"):
            raise ValueError(
                f"TaskSpec.kind must be 'task' or 'zoo', got {self.kind!r}"
            )
        if self.kind == "task" and self.reduced:
            raise ValueError(
                "TaskSpec.reduced applies only to kind='zoo' (it selects "
                "ArchConfig.reduced()); it has no effect on a simulation task "
                "and would only perturb the config fingerprint"
            )
        if self.kind == "zoo" and self.kwargs and not self.reduced:
            raise ValueError(
                "TaskSpec.kwargs for kind='zoo' are ArchConfig.reduced() "
                "overrides and require reduced=True; a full-size arch takes "
                "no construction kwargs"
            )
        object.__setattr__(self, "kwargs", _normalize(self.kwargs))
        object.__setattr__(self, "dataset_kwargs", _normalize(self.dataset_kwargs))


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Client sampler: a ``repro_torch.core.make_sampler`` registry name + kwargs.

    ``n`` and ``budget`` are NOT spec fields — they derive from the built
    dataset and ``FederationSpec.budget`` so the three sections cannot
    disagree about the client population."""

    name: str = "kvib"
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "kwargs", _normalize(self.kwargs))


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    """Algorithm 1's federated-optimization hyperparameters.

    ``batch_size`` is the per-client local batch (``FedConfig.batch_size`` on
    the simulation stack, ``RoundSpec.local_batch`` on the pod-scale stack);
    ``cohort=None`` means the deployable cohort buffer defaults to
    ``min(2 * budget, n_clients)`` on either stack."""

    rounds: int = 100
    budget: int = 10
    cohort: int | None = None
    local_steps: int = 1
    batch_size: int = 64
    local_lr: float = 0.02
    server_opt: str = "fedavg"
    server_opt_kwargs: dict = dataclasses.field(default_factory=dict)
    eval_every: int = 5
    eval_batches: int = 4

    def __post_init__(self):
        if self.server_opt not in _SERVER_OPTS:
            raise ValueError(
                f"unknown server_opt {self.server_opt!r}; "
                f"options: {server_opt_names()}"
            )
        object.__setattr__(
            self, "server_opt_kwargs", _normalize(self.server_opt_kwargs)
        )

    def build_server_opt(self) -> ServerOptimizer:
        return _SERVER_OPTS[self.server_opt](**dict(self.server_opt_kwargs))


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How (not what) to execute: seeds, compilation, fidelity, checkpoints.

    ``mesh_shape``: explicit host-mesh shape, (data, model) or (pod, data,
    model), e.g. ``(2, 1)`` to split the client axis over two ranks; None
    takes ``launch.mesh.make_host_mesh()`` over the default
    ``torch.distributed`` group (``REPRO_MESH_SHAPE`` overrides).  Data
    axes of S > 1 ranks split the client axis over a group of exactly S
    ranks (``ValueError`` without one); a ``model`` axis larger than 1
    raises ``NotImplementedError``.

    ``sampler_axis``: name of the axis to shard the sampler's (N,) client
    axis over.  ``None`` (default) splits it over the mesh's data axes when
    they hold several ranks and keeps it whole otherwise; naming an axis
    hands the sampler a ``launch.mesh.ShardSpec`` over it even with one
    shard, and K-Vib's budget solve then runs the sharded solve (see
    ``core/solver.py``).

    ``score_history_host_offload``: shrink the oracle (T, N) score-history
    buffer to a per-segment device ring drained to host every ``ckpt_every``
    rounds (simulation stack; requires ``ckpt_every > 0``)."""

    seed: int = 0
    compiled: bool = True
    oracle_metrics: bool = True
    exact_oracle_equiv: bool = False
    track_scores: bool = True
    ckpt_every: int = 0
    mesh_shape: tuple | None = None
    sampler_axis: str | None = None
    score_history_host_offload: bool = False

    def __post_init__(self):
        if self.mesh_shape is not None:
            object.__setattr__(
                self, "mesh_shape", tuple(int(x) for x in self.mesh_shape)
            )


_AVAILABILITY_MODES = (None, "bernoulli", "markov", "diurnal")
_LATENCY_DISTS = ("exponential", "uniform", "lognormal")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Deployment-realism axes: availability, deadline stragglers, async.

    The default-constructed spec is fully OFF (``enabled`` is False) and
    both stacks then run the exact PR-7 round body — the fault layer is a
    build-time branch, not a runtime mask, so disabling it reproduces
    pre-fault results bitwise.  All three axes are independent and compose:

    availability / availability_kwargs:
        Time-varying client availability process intersected with every
        sampler's draw (``core.stragglers.availability_step``):
        ``"bernoulli"`` (``q``: scalar or per-client tuple in [0, 1]),
        ``"markov"`` (per-client on/off chain; ``p_on`` = P(off->on),
        ``p_off`` = P(on->off); the chain state lives in the ``TrainState``
        carry), ``"diurnal"`` (deterministic schedule; ``period``, ``duty``).
        The estimator stays unbiased via the composed ``q * p`` correction
        (``core.stragglers.available_draw``).
    deadline / latency / latency_kwargs:
        ``deadline`` (a positive float, ``None`` = off) drops clients whose
        in-trace latency draw exceeds it AFTER local training is scheduled;
        survivor weights are rescaled by ``1 / P(latency <= deadline)``.
        ``latency`` picks the distribution: ``"exponential"`` (``scale``),
        ``"uniform"`` (``lo``, ``hi``), ``"lognormal"`` (``mu``, ``sigma``).
    async_buffer / staleness_discount / round_time:
        ``async_buffer = B > 0`` switches the server to buffered-async
        aggregation: each round's aggregate enters a carried (B, D) ring
        buffer with an in-trace latency-derived arrival round (latency
        quantized by ``round_time``, which defaults to ``deadline`` then
        1.0) and is applied ``staleness_discount ** staleness``-weighted
        when it arrives; still-pending deltas flush once after the horizon.
    """

    availability: str | None = None
    availability_kwargs: dict = dataclasses.field(default_factory=dict)
    deadline: float | None = None
    latency: str = "exponential"
    latency_kwargs: dict = dataclasses.field(default_factory=dict)
    async_buffer: int = 0
    staleness_discount: float = 0.5
    round_time: float | None = None

    def __post_init__(self):
        object.__setattr__(
            self, "availability_kwargs", _normalize(self.availability_kwargs)
        )
        object.__setattr__(self, "latency_kwargs", _normalize(self.latency_kwargs))
        if self.availability not in _AVAILABILITY_MODES:
            raise ValueError(
                f"unknown availability process {self.availability!r}; "
                f"options: {[m for m in _AVAILABILITY_MODES if m]} or null"
            )
        kw = dict(self.availability_kwargs)
        if self.availability is None and kw:
            raise ValueError(
                "FaultSpec.availability_kwargs given but availability is null"
            )
        if self.availability == "bernoulli":
            q = kw.get("q", 0.9)
            qs = [float(v) for v in (q if isinstance(q, tuple) else (q,))]
            if any(not (0.0 <= v <= 1.0) for v in qs):
                raise ValueError(f"bernoulli availability q must lie in [0, 1], got {q!r}")
            if all(v == 0.0 for v in qs):
                raise ValueError("bernoulli availability q is all-zero: no client is ever available")
        elif self.availability == "markov":
            p_on = float(kw.get("p_on", 0.5))
            p_off = float(kw.get("p_off", 0.5))
            if not (0.0 < p_on <= 1.0):
                raise ValueError(f"markov p_on must lie in (0, 1], got {p_on}")
            if not (0.0 <= p_off < 1.0):
                raise ValueError(f"markov p_off must lie in [0, 1), got {p_off}")
        elif self.availability == "diurnal":
            period = float(kw.get("period", 24.0))
            duty = float(kw.get("duty", 0.5))
            if period <= 0.0:
                raise ValueError(f"diurnal period must be positive, got {period}")
            if not (0.0 < duty <= 1.0):
                raise ValueError(f"diurnal duty must lie in (0, 1], got {duty}")
        if self.latency not in _LATENCY_DISTS:
            raise ValueError(
                f"unknown latency distribution {self.latency!r}; "
                f"options: {list(_LATENCY_DISTS)}"
            )
        if self.deadline is not None:
            if float(self.deadline) <= 0.0:
                raise ValueError(f"deadline must be positive, got {self.deadline}")
            # Raises when P(latency <= deadline) ~ 0 (no unbiased reweighting
            # exists); also validates the latency kwargs for the chosen dist.
            deadline_survival(self)
        if int(self.async_buffer) < 0:
            raise ValueError(f"async_buffer must be >= 0, got {self.async_buffer}")
        if not (0.0 < float(self.staleness_discount) <= 1.0):
            raise ValueError(
                f"staleness_discount must lie in (0, 1], got {self.staleness_discount}"
            )
        if self.round_time is not None and float(self.round_time) <= 0.0:
            raise ValueError(f"round_time must be positive, got {self.round_time}")

    @property
    def enabled(self) -> bool:
        """True when ANY fault axis is on (the build-time branch switch)."""
        return (
            self.availability is not None
            or self.deadline is not None
            or int(self.async_buffer) > 0
        )


_DELTA_DTYPES = (None, "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Delta-width axis: quantized client deltas with server error feedback.

    The default-constructed spec is fully OFF (``enabled`` is False) and both
    stacks then run the exact pre-compression round body — like ``FaultSpec``
    this is a build-time branch, not a runtime mask, so a disabled spec
    reproduces uncompressed results bitwise through segmentation and resume.

    delta_dtype:
        ``"int8"`` (symmetric round-to-nearest, +-127) or ``"fp8"``
        (float8_e4m3fn, where the installed torch supports it); ``None`` = off.
        Client deltas are quantized inside the traced round body with one
        fp32 abs-max scale per (cohort slot, ``scale_block``-wide block), so
        the (C, D) stacked buffer lives in device memory at quantized width
        and is widened to f32 only in the registers of the fused aggregation
        kernel (``kernels.fused_dequant_cohort_agg``).  Sampler feedback
        norms are computed from the dequantized values — the regret signal
        is what the estimator actually saw.
    error_feedback:
        When True (default) the server carries a (D,) f32 residual in
        ``TrainState``: each round applies ``d_hat + resid`` and stores the
        fresh quantization error ``d_true - d_hat``, so errors telescope
        instead of accumulating and the final loss stays allclose to the
        uncompressed run.  The residual rides the carry, so SIGKILL/resume
        and sampler-axis sharding stay exact under compression.
    scale_block:
        Block width (in flattened-param elements) sharing one fp32 scale.
        Default 128, the reference's; any width is valid; D is zero-padded
        internally to a block multiple.
    """

    delta_dtype: str | None = None
    error_feedback: bool = True
    scale_block: int = 128

    def __post_init__(self):
        if self.delta_dtype not in _DELTA_DTYPES:
            raise ValueError(
                f"unknown delta_dtype {self.delta_dtype!r}; "
                f"options: {[d for d in _DELTA_DTYPES if d]} or null"
            )
        if self.delta_dtype == "fp8" and not hasattr(torch, "float8_e4m3fn"):
            raise ValueError(
                "delta_dtype 'fp8' needs torch.float8_e4m3fn (torch too old)"
            )
        if int(self.scale_block) <= 0:
            raise ValueError(
                f"scale_block must be positive, got {self.scale_block}"
            )

    @property
    def enabled(self) -> bool:
        """True when a quantized delta width is selected."""
        return self.delta_dtype is not None


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The serving-side geometry and policy (``repro.serve``).

    Like every spec section this is part of the run's identity: the config
    fingerprint covers it, so a server following a checkpoint directory
    (``launch.serve --follow``) provably agrees with the trainer about how
    the model is served, not just how it was trained.  Old spec JSONs
    without a ``serve`` section deserialize to these defaults.

    batch / prompt_len / max_tokens:
        Lockstep decode geometry: ``batch`` concurrent sequences, each
        prefilled from a ``prompt_len``-token prompt and decoded for up to
        ``max_tokens`` new tokens before the batch is refilled (the paged
        cache is allocated for ``prompt_len + max_tokens`` positions).
    page_size:
        KV-cache page width (``models.attention.init_paged_kv_cache``).
    temperature:
        Sampling temperature; 0 = greedy.  Traced data in the decode step —
        changing it never recompiles.
    decode_steps_per_poll:
        Decode chunk length between manifest polls in the serving loop —
        the swap-latency vs. throughput knob.
    eval_batches / tolerance:
        Promotion gate: number of fixed held-out batches scored per
        candidate boundary (batch size follows
        ``FederationSpec.batch_size``, mirroring the simulation stack's
        ``eval_batches`` convention) and the promote slack
        (``loss <= best + tolerance``).
    """

    batch: int = 2
    prompt_len: int = 16
    max_tokens: int = 48
    page_size: int = 16
    temperature: float = 0.0
    decode_steps_per_poll: int = 16
    eval_batches: int = 4
    tolerance: float = 0.0

    def __post_init__(self):
        for field in ("batch", "prompt_len", "max_tokens", "page_size",
                      "decode_steps_per_poll", "eval_batches"):
            if int(getattr(self, field)) < 1:
                raise ValueError(
                    f"ServeSpec.{field} must be >= 1, got {getattr(self, field)}"
                )
        if float(self.temperature) < 0.0:
            raise ValueError(
                f"ServeSpec.temperature must be >= 0, got {self.temperature}"
            )
        if float(self.tolerance) < 0.0:
            raise ValueError(
                f"ServeSpec.tolerance must be >= 0, got {self.tolerance}"
            )

    @property
    def max_seq(self) -> int:
        """The paged cache's static capacity per sequence."""
        return int(self.prompt_len) + int(self.max_tokens)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The canonical, serializable description of one experiment.

    ``repro_torch.api.run(spec)`` executes it; ``to_dict()``'s canonical form is
    what checkpoint manifests fingerprint and what ``--dump-spec`` emits."""

    task: TaskSpec = dataclasses.field(default_factory=TaskSpec)
    sampler: SamplerSpec = dataclasses.field(default_factory=SamplerSpec)
    federation: FederationSpec = dataclasses.field(default_factory=FederationSpec)
    execution: ExecutionSpec = dataclasses.field(default_factory=ExecutionSpec)
    fault: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    compression: CompressionSpec = dataclasses.field(default_factory=CompressionSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        """Lossless plain-dict form (JSON-ready: tuples become lists)."""
        return _jsonable(
            {
                "task": dataclasses.asdict(self.task),
                "sampler": dataclasses.asdict(self.sampler),
                "federation": dataclasses.asdict(self.federation),
                "execution": dataclasses.asdict(self.execution),
                "fault": dataclasses.asdict(self.fault),
                "compression": dataclasses.asdict(self.compression),
                "serve": dataclasses.asdict(self.serve),
            }
        )

    @classmethod
    def from_dict(cls, data: Mapping) -> "ExperimentSpec":
        """Inverse of ``to_dict``; unknown keys raise, naming the field."""
        if not isinstance(data, Mapping):
            raise ValueError(
                f"ExperimentSpec.from_dict needs a mapping, got {type(data).__name__}"
            )
        sections = {
            "task": TaskSpec,
            "sampler": SamplerSpec,
            "federation": FederationSpec,
            "execution": ExecutionSpec,
            "fault": FaultSpec,
            "compression": CompressionSpec,
            "serve": ServeSpec,
        }
        unknown = sorted(set(data) - set(sections))
        if unknown:
            raise ValueError(
                f"unknown field {unknown[0]!r} in ExperimentSpec "
                f"(valid sections: {sorted(sections)})"
            )
        built = {
            key: _from_section(sec_cls, key, data[key])
            for key, sec_cls in sections.items()
            if key in data
        }
        return cls(**built)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- legacy-config projection -------------------------------------------
    def fed_config(self) -> FedConfig:
        """The ``FedConfig`` this spec denotes (the reference's mapping)."""
        fed, ex = self.federation, self.execution
        return FedConfig(
            rounds=fed.rounds,
            budget=fed.budget,
            local_steps=fed.local_steps,
            batch_size=fed.batch_size,
            local_lr=fed.local_lr,
            server_opt=fed.build_server_opt(),
            seed=ex.seed,
            eval_every=fed.eval_every,
            eval_batches=fed.eval_batches,
            oracle_metrics=ex.oracle_metrics,
            compiled=ex.compiled,
            cohort=fed.cohort,
            exact_oracle_equiv=ex.exact_oracle_equiv,
            track_scores=ex.track_scores,
            ckpt_every=ex.ckpt_every,
            score_history_host_offload=ex.score_history_host_offload,
            faults=self.fault if self.fault.enabled else None,
            compression=self.compression if self.compression.enabled else None,
        )

    def round_spec(self):
        """The zoo round's ``RoundSpec`` this spec denotes (zoo kind).

        ``cohort=None`` resolves at build time (``repro_torch.api.build``),
        where the client count is known; here it must already be concrete."""
        from repro_torch.fed.round import RoundSpec

        fed = self.federation
        if fed.cohort is None:
            raise ValueError(
                "FederationSpec.cohort is None; resolve it against the client "
                "count first (repro_torch.api.build does this automatically)"
            )
        if fed.server_opt != "fedavg":
            raise ValueError(
                f"server_opt {fed.server_opt!r} is only supported on the "
                "simulation stack (kind='task'); the zoo round applies a "
                "stateless x - server_lr * d update (fedavg)"
            )
        server_lr = float(dict(fed.server_opt_kwargs).get("lr", 1.0))
        return RoundSpec(
            cohort=int(fed.cohort),
            local_steps=fed.local_steps,
            local_lr=fed.local_lr,
            server_lr=server_lr,
            local_batch=fed.batch_size,
            faults=self.fault if self.fault.enabled else None,
            compression=self.compression if self.compression.enabled else None,
        )
