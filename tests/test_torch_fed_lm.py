"""The paper's Figure 5 example (``fed_lm``) and its table on the port.

The port's ``repro_torch.examples.fed_lm`` builds the reference example's
specs (captured by running the reference's ``main`` with ``repro.api.run``
replaced by a recorder), runs ``--model tiny`` and ``--model zoo`` (each family, and all four by
default) on the CPU, and one zoo cell of each family follows
``repro.api.run`` on the reference's replayed draws; ``bench.tables.table_fed_lm`` prints the
reference's fig5 rows for the same JSON, the MISSING row included.
"""
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.bench import tables  # noqa: E402
from repro_torch.examples import fed_lm  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402
from test_torch_paper_examples import ROOT, _Hist, _load, ref_example  # noqa: E402
from test_torch_slice import METRIC_TOL, jax_replay  # noqa: E402
from test_torch_zoo_round import one_intraop_thread  # noqa: E402,F401  (autouse)


def reference_specs(argv, monkeypatch) -> list:
    """The specs the reference ``fed_lm.main`` runs, in order."""
    mod = ref_example("fed_lm")
    specs = []

    def run(spec, **kw):
        specs.append(spec)
        return _Hist(spec.federation.rounds)

    monkeypatch.setattr(ref_api, "run", run)
    monkeypatch.setattr(sys, "argv", ["fed_lm"] + argv)
    mod.main()
    return specs


def port_specs(argv) -> list:
    args = fed_lm.parse_args(argv)
    return [fed_lm.spec_for(args, s, name, kw)
            for s in args.samplers for name, kw, _ in fed_lm.variants(args)]


SPEC_CASES = [
    [],
    ["--rounds", "7", "--clients", "12", "--budget", "3", "--seq", "16", "--vocab", "64"],
    ["--model", "zoo", "--archs", "smollm", "ssm"],
    ["--model", "zoo", "--archs", "ssm", "--samplers", "kvib", "mabs", "--rounds", "5"],
    ["--model", "zoo", "--archs", "moe", "xlstm", "--samplers", "vrb", "--rounds", "4"],
]


@pytest.mark.parametrize("argv", SPEC_CASES, ids=[f"case{i}" for i in range(len(SPEC_CASES))])
def test_specs_equal_reference(argv, monkeypatch, tmp_path):
    want = reference_specs(argv + ["--out", str(tmp_path / "ref.json")], monkeypatch)
    got = port_specs(argv)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.to_dict() == w.to_dict()


def test_zoo_tasks_match_the_reference_config():
    """The registered zoo tasks build the reference's reduced configs."""
    from repro_torch.configs import get_config

    ref_mod = ref_example("fed_lm")
    for arch in ("smollm", "moe", "ssm", "xlstm"):
        assert fed_lm.ZOO_ARCHS[arch][0] == ref_mod.ZOO_ARCHS[arch][0]
        name, over = fed_lm.ZOO_ARCHS[arch]
        cfg = get_config(name).reduced(vocab=64, **over)
        ref_cfg = ref_mod.zoo_lm_task(64, arch)
        assert fed_lm.zoo_lm_task(64, arch).name == ref_cfg.name == cfg.name
    assert set(fed_lm.ZOO_ARCHS) == set(ref_mod.ZOO_ARCHS)
    assert "zoo_reduced_lm" in api.task_names() and "smollm_reduced_lm" in api.task_names()


@pytest.fixture(scope="module")
def shared_runs():
    """``api.run(spec, device)`` once a spec for the module: the
    ``fed_lm.main`` calls of ``test_tiny_and_zoo_run_on_the_cpu`` and
    ``test_zoo_families_run`` run the same zoo cells (kvib, 2 rounds, N = 8,
    the same cut flags), each family once in all.  Runs with other
    arguments (a replayed source) go through as they are."""
    run, memo = api.run, {}

    def once(spec, device, **kw):
        if kw:
            return run(spec, device, **kw)
        key = (spec.to_json(), str(device))
        if key not in memo:
            memo[key] = run(spec, device)
        return memo[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "run", once)
        yield memo


def _finite_runs(res, keys):
    assert sorted(res["runs"]) == sorted(keys)
    for run in res["runs"].values():
        for field in ("loss", "regret", "sq_error"):
            assert len(run[field]) == res["config"]["rounds"]
            assert all(math.isfinite(x) for x in run[field])


def test_tiny_and_zoo_run_on_the_cpu(tmp_path, capsys, shared_runs):
    small = ["--device", "cpu", "--rounds", "2", "--clients", "8", "--budget", "2",
             "--seq", "16", "--vocab", "64"]
    tiny = fed_lm.main(small + ["--samplers", "kvib", "vrb", "--out", str(tmp_path / "t.json")])
    _finite_runs(tiny, ["kvib", "vrb"])
    zoo = fed_lm.main(small + ["--model", "zoo", "--archs", "smollm", "ssm", "--samplers", "kvib",
                               "--out", str(tmp_path / "z" / "fed_lm.json")])
    _finite_runs(zoo, ["kvib/smollm", "kvib/ssm"])
    assert json.loads((tmp_path / "z" / "fed_lm.json").read_text())["runs"].keys() == zoo["runs"].keys()
    out = capsys.readouterr().out
    assert "kvib/ssm" in out and "wrote" in out


@pytest.mark.parametrize("arch", ["smollm", "moe", "ssm", "xlstm"])
def test_zoo_cell_matches_reference(arch):
    """One ``--model zoo`` cell, 2 rounds (kvib, N = 8, K = 2): the port on
    the reference's replayed draws follows ``repro.api.run``."""
    ref_example("fed_lm")  # registers the reference's zoo tasks
    args = fed_lm.parse_args(["--model", "zoo", "--rounds", "2", "--clients", "8", "--budget", "2",
                              "--seq", "16", "--vocab", "64"])
    spec = fed_lm.spec_for(args, "kvib", "zoo_reduced_lm", {"arch": arch})
    ref_spec = ref_api.ExperimentSpec.from_json(spec.to_json())
    ref_built = ref_api.build(ref_spec)
    want = ref_api.run(ref_spec, built=ref_built)
    got = api.run(spec, "cpu", random_source=jax_replay(ref_built))
    assert got.cohort_size == want.cohort_size
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    np.testing.assert_allclose(got.estimator_sq_error, want.estimator_sq_error, **METRIC_TOL)
    np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
    ref_leaves = jax.tree_util.tree_leaves(want.final_params)
    got_leaves = tree_leaves(got.final_params)
    assert len(got_leaves) == len(ref_leaves)
    for a, b in zip(got_leaves, ref_leaves):
        b = np.asarray(b)
        assert float(np.abs(a - b).max()) <= 1e-5 * max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("argv", [
    ["--model", "zoo", "--archs", "moe"],
    ["--model", "zoo", "--archs", "smollm", "xlstm"],
    ["--model", "zoo"],
], ids=["moe", "smollm_xlstm", "default_archs"])
def test_zoo_families_run(argv, monkeypatch, tmp_path, capsys, shared_runs):
    """The argument lists the port refused before the moe and xlstm families
    were ported: their specs equal the reference's, they run on the CPU
    (rounds and clients cut, one sampler), and the reference's table prints
    the port's JSON as the port's table does, one fig5 row a run."""
    want = reference_specs(argv + ["--out", str(tmp_path / "ref.json")], monkeypatch)
    assert [g.to_dict() for g in port_specs(argv)] == [w.to_dict() for w in want]
    cut = ["--device", "cpu", "--rounds", "2", "--clients", "8", "--budget", "2", "--seq", "16",
           "--vocab", "64", "--samplers", "kvib", "--out", str(tmp_path / "fed_lm.json")]
    res = fed_lm.main(argv + cut)
    archs = fed_lm.parse_args(argv).archs
    _finite_runs(res, [f"kvib/{a}" for a in archs])
    capsys.readouterr()
    bench = _load(ROOT / "benchmarks" / "run.py", "_ref_benchmarks_run")
    monkeypatch.setattr(bench, "RESULTS", str(tmp_path))
    bench.table_fed_lm()
    ref_rows = capsys.readouterr().out.splitlines()
    rows = tables.table_fed_lm(str(tmp_path))
    assert capsys.readouterr().out.splitlines() == ref_rows
    assert [r[0] for r in rows] == [f"fig5_lm_kvib/{a}" for a in archs]


def test_table_prints_reference_rows(tmp_path, monkeypatch, capsys):
    bench = _load(ROOT / "benchmarks" / "run.py", "_ref_benchmarks_run")
    monkeypatch.setattr(bench, "RESULTS", str(tmp_path))
    bench.table_fed_lm()
    missing = capsys.readouterr().out.splitlines()
    rows = tables.table_fed_lm(str(tmp_path))
    assert [r[0] for r in rows] == ["fig5_fed_lm"] and "MISSING" in rows[0][2]
    got = capsys.readouterr().out.splitlines()
    assert got[0].split(",")[:2] == missing[0].split(",")[:2]
    runs = {"kvib/smollm": {"loss": [5.5512, 5.1], "regret": [0.0], "sq_error": [0.1]},
            "uniform_isp": {"loss": [4.0, 3.91234], "regret": [0.0], "sq_error": [0.1]}}
    (tmp_path / "fed_lm.json").write_text(json.dumps({"config": {}, "runs": runs}))
    bench.table_fed_lm()
    want = capsys.readouterr().out.splitlines()
    rows = tables.main(["--results-dir", str(tmp_path)])
    got = capsys.readouterr().out.splitlines()
    assert [line for line in got if line.startswith("fig5")] == want
    assert [r[0] for r in rows if r[0].startswith("fig5")] == ["fig5_lm_kvib/smollm", "fig5_lm_uniform_isp"]
