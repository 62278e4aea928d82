"""The paper's examples and their tables on the port, against the reference.

The data pieces the examples need (``dirichlet_label_partition``,
``FederatedDataset.batch_all_clients``, the vision-like generator) equal the
reference's exactly; each port example builds the reference example's specs
(captured by running the reference's ``main`` with ``repro.api.build`` and
``repro.api.run`` replaced by recorders); one femnist v3 cell follows
``repro.api.run`` on the reference's replayed draws; ``bench.tables``
prints the reference's rows for the same JSON; the dataset registry
memoizes per device.
"""
import importlib.util
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.data import partition as ref_partition  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import runner  # noqa: E402
from repro_torch.bench import tables  # noqa: E402
from repro_torch.data import FederatedDataset, dirichlet_label_partition  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    budget_sweep,
    femnist_style,
    quickstart,
    synthetic_regret,
)
from test_torch_slice import METRIC_TOL, PARAM_TOL, jax_replay  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    """A module of the reference's examples or benchmarks, by file path."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ref_example(name: str):
    return _load(ROOT / "examples" / f"{name}.py", f"_ref_example_{name}")


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("n_clients,beta,seed", [(5, 0.5, 0), (12, 0.1, 3), (7, 2.0, 11)])
def test_dirichlet_label_partition_matches_reference(n_clients, beta, seed):
    labels = np.random.default_rng(seed).integers(0, 6, size=400)
    got = dirichlet_label_partition(labels, n_clients, beta=beta, seed=seed)
    want = ref_partition.dirichlet_label_partition(labels, n_clients, beta=beta, seed=seed)
    assert len(got) == len(want) == n_clients
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(400))


def _small_spec(**kw):
    return ref_api.ExperimentSpec(task=ref_api.TaskSpec(
        dataset_kwargs=dict(n_clients=9, total=450, power=2.0, seed=4, **kw)))


def test_batch_all_clients_matches_reference_gather():
    """At the reference's own indices (its key split and per-client randint)
    the port's one gather returns the reference's batches exactly."""
    ref_ds = ref_api.build(_small_spec()).dataset
    key = jax.random.PRNGKey(999)
    want_x, want_y = ref_ds.batch_all_clients(key, 8)
    keys = jax.random.split(key, ref_ds.n_clients)
    idx = np.stack([
        np.asarray(jax.random.randint(k, (8,), 0, ref_ds.sizes[i])) for i, k in enumerate(keys)
    ])
    ds = api.build(api.ExperimentSpec.from_json(_small_spec().to_json()), "cpu").dataset
    x, y = ds.batch_all_clients(8, idx=idx)
    assert x.shape == (9, 8, 60) and y.shape == (9, 8)
    np.testing.assert_array_equal(x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))


def test_batch_all_clients_generator_draws_in_range():
    ds = api.build(api.ExperimentSpec.from_json(_small_spec().to_json()), "cpu").dataset
    a = ds.batch_all_clients(64, generator=torch.Generator().manual_seed(1))
    b = ds.batch_all_clients(64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # Each row comes from its own client's valid region: compare to a gather
    # at indices recovered by matching rows.
    for i in range(ds.n_clients):
        valid = ds.features[i, : int(ds.sizes[i])]
        hits = (a[0][i][:, None, :] == valid[None]).all(-1).any(-1)
        assert bool(hits.all())


@pytest.mark.parametrize("n_clients,alpha,seed", [(60, 1.2, 0), (24, 2.2, 3)])
def test_make_vision_like_bitwise_reference(n_clients, alpha, seed):
    want = ref_example("femnist_style").make_vision_like(n_clients, alpha, seed)
    got = femnist_style.make_vision_like(n_clients, alpha, seed)
    np.testing.assert_array_equal(got.features.numpy(), np.asarray(want.features))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))


# -- the examples' specs ------------------------------------------------------


class _Hist:
    """Just enough of a History for the reference examples' printing."""

    def __init__(self, rounds):
        self.train_loss = [0.5] * rounds
        self.test_accuracy = [0.5] * (rounds // 5 + 1)
        self.estimator_sq_error = [0.1] * rounds
        self.cohort_size = [1] * rounds
        self.wall_time_s = 0.0
        self.regret = types.SimpleNamespace(dynamic_regret=lambda: np.ones(rounds))

    def summary(self):
        return {"final_loss": 0.5, "final_acc": 0.5, "mean_sq_error": 0.1,
                "final_dynamic_regret_per_round": 0.01, "wall_time_s": 0.0}


def reference_specs(name, argv, monkeypatch) -> list:
    """The specs the reference example's ``main`` runs, in order."""
    mod = ref_example(name)
    specs = []
    ds = types.SimpleNamespace(
        sizes=np.arange(1, 21),
        batch_all_clients=lambda key, b: (jnp.zeros((2, b, 196)), jnp.zeros((2, b), jnp.int32)),
    )

    def run(spec, **kw):
        specs.append(spec)
        return _Hist(spec.federation.rounds)

    monkeypatch.setattr(ref_api, "build", lambda spec: types.SimpleNamespace(dataset=ds))
    monkeypatch.setattr(ref_api, "run", run)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()
    return specs


def port_specs(name, argv):
    mod = {"quickstart": quickstart, "budget_sweep": budget_sweep,
           "synthetic_regret": synthetic_regret, "femnist_style": femnist_style}[name]
    args = mod.parse_args(argv)
    if name == "quickstart":
        return [quickstart.spec_for(args, s) for s in quickstart.SAMPLERS]
    if name == "budget_sweep":
        return [budget_sweep.make_spec(args, s, k) for s in args.samplers for k in args.budgets]
    if name == "synthetic_regret":
        out = []
        for seed in range(args.seeds):
            for s in synthetic_regret.SAMPLERS:
                kw = {"horizon": args.rounds} if s in ("kvib", "vrb") else {}
                out.append(synthetic_regret.make_spec(args, s, seed, not args.python_loop, **kw))
        if args.gamma_sweep:
            for gamma in (1e-4, 1e-3, 1e-2, 1e-1, 1.0):
                out.append(synthetic_regret.make_spec(
                    args, "kvib", 0, not args.python_loop, horizon=args.rounds, gamma=gamma))
        return out
    return [femnist_style.spec_for(args, lv, s)
            for lv in femnist_style.LEVELS for s in args.samplers]


SPEC_CASES = [
    ("quickstart", []),
    ("quickstart", ["--clients", "30", "--rounds", "7", "--budget", "3", "--seed", "2",
                    "--python-loop"]),
    ("budget_sweep", []),
    ("budget_sweep", ["--rounds", "9", "--budgets", "2", "6", "--samplers", "vrb", "kvib",
                      "--python-loop"]),
    ("synthetic_regret", []),
    ("synthetic_regret", ["--clients", "20", "--rounds", "10", "--seeds", "2", "--gamma-sweep"]),
    ("femnist_style", []),
    ("femnist_style", ["--rounds", "40", "--samplers", "kvib", "vrb"]),
]


@pytest.mark.parametrize("name,argv", SPEC_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SPEC_CASES)])
def test_example_specs_equal_reference(name, argv, monkeypatch, tmp_path):
    out = [] if name == "quickstart" else ["--out", str(tmp_path / "ref.json")]
    want = reference_specs(name, argv + out, monkeypatch)
    got = port_specs(name, argv)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.to_dict() == w.to_dict()


# -- one femnist cell against the reference -----------------------------------


def test_femnist_v3_cell_matches_reference():
    """kvib at v3 (N=60, K=5, the MLP at dim 196, hidden 128, depth 2), 4
    rounds: ``repro_torch.api.run`` on the reference's replayed draws
    follows ``repro.api.run`` within the slice's tolerances."""
    ref_example("femnist_style")  # registers the reference's "vision_like"
    args = femnist_style.parse_args(["--rounds", "4"])
    spec = femnist_style.spec_for(args, "v3", "kvib")
    ref_spec = ref_api.ExperimentSpec.from_json(spec.to_json())
    ref_built = ref_api.build(ref_spec)
    x = np.asarray(ref_built.dataset.features[:, :4]).reshape(-1, 196)
    y = np.asarray(ref_built.dataset.labels[:, :4]).reshape(-1)
    want = ref_api.run(ref_spec, built=ref_built, eval_data=(x, y))
    got = api.run(spec, "cpu", random_source=jax_replay(ref_built), eval_data=(x, y))
    assert got.cohort_size == want.cohort_size
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    np.testing.assert_allclose(got.estimator_sq_error, want.estimator_sq_error, **METRIC_TOL)
    np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
    np.testing.assert_allclose(got.test_accuracy, want.test_accuracy, atol=1e-6)
    ref_leaves = jax.tree_util.tree_leaves(want.final_params)
    got_leaves = [got.final_params[f"l{i}"][k] for i in range(3) for k in ("b", "w")]
    assert len(got_leaves) == len(ref_leaves)
    for a, b in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(a, np.asarray(b), **PARAM_TOL)


# -- tables -------------------------------------------------------------------


def _hand_made_results(d: Path) -> None:
    d.mkdir(parents=True, exist_ok=True)
    runs = {
        name: [{"regret": [0.1, 0.2 * (i + 1), 0.35 * (i + 1)], "sq_error": [0.3, 0.2, 0.1 * (i + 1)]}
               for i in range(2)]
        for name in ("uniform_isp", "kvib")
    }
    runs["kvib_gamma"] = [{"gamma": 0.1, "regret": 1.0, "sq_error": 0.1}]
    (d / "synthetic.json").write_text(json.dumps({"config": {"rounds": 3}, "runs": runs}))
    (d / "budget.json").write_text(json.dumps({"config": {}, "regret_per_round": {
        "kvib": {"10": 0.02, "5": 0.08, "40": 0.001}, "vrb": {"5": 0.05, "40": 0.04}}}))
    (d / "femnist.json").write_text(json.dumps({"config": {}, "levels": {
        lv: {"samplers": {"kvib": {"acc": [0.1, 0.61], "sq_error": [0.2, 0.4],
                                   "rounds_to_target": 5},
                          "vrb": {"acc": [0.3], "sq_error": [0.25], "rounds_to_target": None}}}
        for lv in ("v1", "v3")}}))
    (d / "fed_lm.json").write_text(json.dumps({"config": {}, "runs": {
        "kvib": {"loss": [5.5, 5.25], "regret": [0.0], "sq_error": [0.1]},
        "vrb/ssm": {"loss": [5.4, 4.0]}}}))


def test_tables_print_reference_rows(tmp_path, monkeypatch, capsys):
    _hand_made_results(tmp_path)
    bench = _load(ROOT / "benchmarks" / "run.py", "_ref_benchmarks_run")
    monkeypatch.setattr(bench, "RESULTS", str(tmp_path))
    for fn in ("table_synthetic", "table_budget", "table_femnist", "table_fed_lm"):
        getattr(bench, fn)()
    want = capsys.readouterr().out.splitlines()
    rows = tables.main(["--results-dir", str(tmp_path)])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == "name,us_per_call,derived"
    assert got[1:] == want
    assert [r[0] for r in rows] == [w.split(",")[0] for w in want]
    assert {r[0] for r in rows} >= {"fig2_regretT_kvib", "fig3b_kvib", "fig4_v3_vrb"}


def test_tables_report_missing_results(tmp_path, capsys):
    rows = tables.main(["--results-dir", str(tmp_path / "none")])
    assert [r[0] for r in rows] == ["fig2_synthetic", "fig3b_budget", "fig4_femnist", "fig5_fed_lm"]
    assert all("MISSING" in r[2] for r in rows)


# -- registries -----------------------------------------------------------------


def test_register_dataset_memoizes(monkeypatch):
    monkeypatch.setattr(runner, "_DATASET_CACHE", {})
    calls = []

    def factory(n_clients, seed):
        calls.append((n_clients, seed))
        rng = np.random.default_rng(seed)
        return FederatedDataset(torch.from_numpy(rng.standard_normal((n_clients, 5, 3)).astype(np.float32)),
                                torch.zeros((n_clients, 5), dtype=torch.int32),
                                torch.full((n_clients,), 5, dtype=torch.int64))

    api.register_dataset("memo_test", factory)
    assert "memo_test" in api.dataset_names() and "synthetic_classification" in api.dataset_names()
    spec = api.ExperimentSpec(task=api.TaskSpec(
        kwargs={"dim": 3, "n_classes": 2}, dataset="memo_test",
        dataset_kwargs={"n_clients": 4, "seed": 1}))
    a, b = api.build(spec, "cpu"), api.build(spec, "cpu")
    assert calls == [(4, 1)] and a.dataset is b.dataset
    other = api.ExperimentSpec.from_dict(
        {**spec.to_dict(), "task": {**spec.to_dict()["task"], "dataset_kwargs": {"n_clients": 4, "seed": 2}}})
    api.build(other, "cpu")
    assert calls == [(4, 1), (4, 2)]
    # Re-registered under the same name: another factory object, a miss.
    api.register_dataset("memo_test", lambda **kw: factory(**kw))
    api.build(spec, "cpu")
    assert calls == [(4, 1), (4, 2), (4, 1)]
    # At most four entries, the oldest evicted first.
    for seed in range(3, 8):
        api.build(api.ExperimentSpec.from_dict({**other.to_dict(), "task": {
            **other.to_dict()["task"], "dataset_kwargs": {"n_clients": 4, "seed": seed}}}), "cpu")
    assert len(runner._DATASET_CACHE) == 4
    assert all(k[3] == "cpu" for k in runner._DATASET_CACHE)


def test_register_task_and_bad_factory(monkeypatch):
    from repro_torch.fed import tasks

    monkeypatch.setattr(runner, "_DATASET_CACHE", {})
    api.register_task("logreg_alias", tasks.logistic_regression)
    assert "logreg_alias" in api.task_names() and "logreg" in api.task_names()
    spec = api.ExperimentSpec(
        task=api.TaskSpec(name="logreg_alias", dataset_kwargs={"n_clients": 4, "total": 64}),
        federation=api.FederationSpec(rounds=1))
    assert len(api.run(spec, "cpu").train_loss) == 1
    api.register_dataset("not_a_dataset", lambda: np.zeros(3))
    with pytest.raises(TypeError, match="FederatedDataset"):
        api.build(api.ExperimentSpec(task=api.TaskSpec(dataset="not_a_dataset")), "cpu")
    with pytest.raises(ValueError, match="register_task"):
        api.build(api.ExperimentSpec(task=api.TaskSpec(name="nope")), "cpu")


# -- the examples end to end on the CPU -----------------------------------------

RUNS = {
    "quickstart": ["--clients", "12", "--rounds", "6", "--budget", "3"],
    "synthetic_regret": ["--clients", "12", "--rounds", "6", "--budget", "3", "--seeds", "1"],
    "budget_sweep": ["--clients", "12", "--rounds", "6", "--budgets", "2", "4",
                     "--samplers", "kvib", "vrb"],
}


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs_on_cpu(name, tmp_path):
    mod = {"quickstart": quickstart, "synthetic_regret": synthetic_regret,
           "budget_sweep": budget_sweep}[name]
    out = tmp_path / {"quickstart": "quickstart.json", "synthetic_regret": "synthetic.json",
                      "budget_sweep": "budget.json"}[name]
    results = mod.main(RUNS[name] + ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["config"]["device"] == "cpu"
    if name == "quickstart":
        assert set(results["summary"]) == {"uniform_isp", "kvib"}
        assert all(np.isfinite(s["final_loss"]) for s in results["summary"].values())
    elif name == "budget_sweep":
        assert set(results["regret_per_round"]["kvib"]) == {"2", "4"}
    else:
        assert set(results["runs"]) == set(synthetic_regret.SAMPLERS)
        rows = tables.table_synthetic(str(tmp_path))
        assert len(rows) == len(synthetic_regret.SAMPLERS)
