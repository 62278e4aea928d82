"""The port's federated round against the JAX reference, end to end on the CPU.

``repro_torch.api.run`` (device="cpu") replays the reference's own random
draws — the ISP uniforms, cohort priorities, batch indices and initial
parameters, derived along ``repro.fed.server``'s key chain
(``build_segment_runner``, ``_derive_keys_step``, ``_split_batch_keys``,
``fold_in(k_sample, 1)`` for the cohort) — and must then follow
``repro.api.run`` round by round.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import samplers as pt_samplers  # noqa: E402
from repro_torch.rng import ReplaySource  # noqa: E402

ROUNDS = 3
# Final parameters after 3 rounds: f32 sums in another order (XLA vs ATen)
# drift by a few ulps per op; 1e-4 relative is well above that drift.
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)


def _spec(task: str, oracle: bool) -> "ref_api.ExperimentSpec":
    if task == "logreg":
        t = ref_api.TaskSpec(
            name="logreg",
            dataset="synthetic_classification",
            dataset_kwargs=dict(n_clients=16, total=1600, power=2.0, seed=3),
        )
        # cohort=2 < budget: the deployable run overflows and drops clients.
        fed = dict(local_steps=2, batch_size=16, local_lr=0.05, cohort=2)
    else:
        t = ref_api.TaskSpec(
            name="tiny_lm",
            kwargs=dict(vocab=64, d_model=32, n_layers=1),
            dataset="synthetic_tokens",
            dataset_kwargs=dict(
                n_clients=10, seq_len=16, vocab=64, total_seqs=300, power=2.2, seed=0
            ),
        )
        fed = dict(local_steps=1, batch_size=4, local_lr=0.3, cohort=4)
    return ref_api.ExperimentSpec(
        task=t,
        sampler=ref_api.SamplerSpec(name="kvib", kwargs={"horizon": ROUNDS}),
        federation=ref_api.FederationSpec(rounds=ROUNDS, budget=3, eval_every=5, **fed),
        execution=ref_api.ExecutionSpec(seed=1, oracle_metrics=oracle),
    )


_STANDARD = {  # the latency family's standard variate, as the reference draws it
    "exponential": lambda key, shape: jax.random.exponential(key, shape, jnp.float32),
    "uniform": lambda key, shape: jax.random.uniform(key, shape, jnp.float32),
    "lognormal": lambda key, shape: jax.random.normal(key, shape, jnp.float32),
}


def jax_replay(built, device="cpu") -> ReplaySource:
    """The reference run's draws, along its own key chain: the ISP uniforms
    and the RSP draws' inputs from ``k_sample``, and with a fault section
    also the fault layer's (``fold_in(k_sample, 101/102/103)``)."""
    cfg = built.fed_config
    n = built.dataset.n_clients
    r, b = cfg.local_steps, cfg.batch_size
    sizes = jnp.asarray(built.dataset.sizes)
    fault = cfg.faults
    lat_width = n if cfg.oracle_metrics else cfg.cohort_slots(n)
    key = jax.random.PRNGKey(cfg.seed)
    key, init_key = jax.random.split(key)
    init = jax.tree_util.tree_map(np.asarray, built.task.init(init_key))

    def client_idx(i, keys):
        return jax.vmap(lambda k: jax.random.randint(k, (b,), 0, sizes[i]))(keys)

    budget = cfg.budget
    uniforms, priorities, idx, rsp_u, rsp_idx = [], [], [], [], []
    faults = {"avail_uniforms": [], "latencies": [], "async_latencies": []}
    for _ in range(cfg.rounds):
        key, k_data, k_sample = jax.random.split(key, 3)
        uniforms.append(np.asarray(jax.random.uniform(k_sample, (n,))))
        # The RSP draws' inputs: jax.random.choice(k_sample, n, (K,), p=p)
        # searches at these uniforms; without replacement it takes the first
        # K of this permutation.
        rsp_u.append(np.asarray(jax.random.uniform(k_sample, (budget,))))
        rsp_idx.append(np.asarray(jax.random.permutation(k_sample, n))[:budget])
        priorities.append(
            np.asarray(jax.random.uniform(jax.random.fold_in(k_sample, 1), (n,)))
        )
        batch_keys = jax.random.split(k_data, n * r).reshape(n, r, 2)
        idx.append(np.asarray(jax.vmap(client_idx)(jnp.arange(n), batch_keys)))
        if fault is not None:
            std = _STANDARD[fault.latency]
            faults["avail_uniforms"].append(
                np.asarray(jax.random.uniform(jax.random.fold_in(k_sample, 101), (n,)))
            )
            faults["latencies"].append(
                np.asarray(std(jax.random.fold_in(k_sample, 102), (lat_width,)))
            )
            faults["async_latencies"].append(
                np.asarray(std(jax.random.fold_in(k_sample, 103), ()))
            )
    extra = {k: np.stack(v) for k, v in faults.items()} if fault is not None and cfg.rounds else {}
    if cfg.rounds:
        extra.update(rsp_uniforms=np.stack(rsp_u), rsp_indices=np.stack(rsp_idx))
    return ReplaySource(
        init, np.stack(uniforms), np.stack(priorities), np.stack(idx), device, **extra
    )


@pytest.fixture
def draw_log(monkeypatch):
    """Every (uniforms, marginals) pair the port's ISP draw sees."""
    log = []
    real = pt_samplers._isp_draw

    def recording(uniforms, marginals):
        log.append((uniforms.numpy().copy(), marginals.numpy().copy()))
        return real(uniforms, marginals)

    monkeypatch.setattr(pt_samplers, "_isp_draw", recording)
    return log


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_params_close(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "deployable"])
@pytest.mark.parametrize("task", ["logreg", "tiny_lm"])
def test_run_matches_reference(task, oracle, draw_log):
    ref_spec = _spec(task, oracle)
    ref_built = ref_api.build(ref_spec)
    x, y = np.asarray(ref_built.dataset.features[0]), np.asarray(ref_built.dataset.labels[0])
    eval_data = (x[:32], y[:32])
    want = ref_api.run(ref_spec, built=ref_built, eval_data=eval_data)

    spec = api.ExperimentSpec.from_json(ref_spec.to_json())
    got = api.run(spec, device="cpu", random_source=jax_replay(ref_built), eval_data=eval_data)

    # A mask bit must not hinge on rounding: every replayed uniform sits
    # clear of its marginal.
    assert len(draw_log) == ROUNDS
    for u, p in draw_log:
        assert np.min(np.abs(u - p)) > 1e-5

    assert got.cohort_size == want.cohort_size
    assert got.cohort_dropped == want.cohort_dropped
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    assert len(got.test_accuracy) == len(want.test_accuracy) == 2  # rounds 0 and 2
    np.testing.assert_allclose(got.test_accuracy, want.test_accuracy, atol=1e-6)
    if oracle:
        np.testing.assert_allclose(
            got.estimator_sq_error, want.estimator_sq_error, **METRIC_TOL
        )
        np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
        np.testing.assert_allclose(
            got.regret.opt_costs, want.regret.opt_costs, **METRIC_TOL
        )
    _assert_params_close(got.final_params, want.final_params)


def test_compiled_and_eager_loops_agree():
    """Device-resident metrics (compiled=True) and per-round host copies
    (compiled=False) give bitwise-identical runs."""
    ref_spec = _spec("logreg", oracle=False)
    spec = api.ExperimentSpec.from_json(ref_spec.to_json())
    eager = api.ExperimentSpec.from_dict(
        {**spec.to_dict(), "execution": {**spec.to_dict()["execution"], "compiled": False}}
    )
    a = api.run(spec, device="cpu")
    b = api.run(eager, device="cpu")
    assert a.train_loss == b.train_loss and a.cohort_size == b.cohort_size
    for k in a.final_params:
        np.testing.assert_array_equal(a.final_params[k], b.final_params[k])


def test_spec_json_loads_unchanged(tmp_path):
    """A spec JSON saved by repro.api loads into repro_torch.api unchanged and
    serializes back to the same dict; unknown keys are rejected the same way."""
    ref_spec = ref_api.ExperimentSpec(
        task=ref_api.TaskSpec(name="tiny_lm", kwargs={"vocab": 64}, dataset="synthetic_tokens"),
        fault=ref_api.FaultSpec(deadline=2.0, latency="uniform", latency_kwargs={"hi": 3.0}),
        compression=ref_api.CompressionSpec(delta_dtype="int8"),
        execution=ref_api.ExecutionSpec(mesh_shape=(2, 1)),
    )
    path = ref_spec.save(str(tmp_path / "spec.json"))
    spec = api.ExperimentSpec.load(path)
    assert spec.to_dict() == ref_spec.to_dict()
    assert spec.to_json() == ref_spec.to_json()

    bad = json.loads(ref_spec.to_json())
    bad["federation"]["lr"] = 0.1
    for mod in (ref_api, api):
        with pytest.raises(ValueError, match="unknown field 'lr'"):
            mod.ExperimentSpec.from_dict(bad)


@pytest.mark.parametrize(
    "section",
    [
        {"task": {"kind": "zoo", "name": "qwen3-moe-235b-a22b"}},
        {"execution": {"oracle_metrics": False, "exact_oracle_equiv": True}},
    ],
    ids=["zoo", "exact_oracle_equiv"],
)
def test_unported_parts_raise(section):
    """An unported part (a zoo arch of the moe family) raises
    ``NotImplementedError`` naming its ``ROADMAP.md`` item.
    ``exact_oracle_equiv`` was such a part until it was ported; its case now
    checks that it runs.  The zoo round itself runs since it was ported
    (``tests/test_torch_zoo_round.py``)."""
    spec = api.ExperimentSpec.from_dict(
        {**section, "federation": {"rounds": 1}, "task": section.get(
            "task", {"dataset_kwargs": {"n_clients": 4, "total": 64}})}
    )
    if spec.task.kind != "zoo":
        hist = api.run(spec, device="cpu")
        assert len(hist.train_loss) == 1 and np.isfinite(hist.train_loss[0])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.run(spec, device="cpu")


def test_compression_with_exact_oracle_equiv_is_refused():
    """The reference's ValueError for compression with exact_oracle_equiv."""
    spec = api.ExperimentSpec.from_dict({
        "task": {"dataset_kwargs": {"n_clients": 4, "total": 64}},
        "federation": {"rounds": 1},
        "execution": {"oracle_metrics": False, "exact_oracle_equiv": True},
        "compression": {"delta_dtype": "int8"},
    })
    with pytest.raises(ValueError, match="exact_oracle_equiv"):
        api.run(spec, device="cpu")
