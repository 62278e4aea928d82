"""The port's trace-invariant lint (``repro_torch.analysis.lint``), on the
CPU: the reference's tests (``tests/test_lint.py``) over ATen graphs.

* seeded violations: an O(N*D) body, a sampler with a host sync, an f64
  leak, a data-dependent branch or shape, a drifting state leaf, a Python
  scalar in the carry each give EXACTLY ONE finding of their kind, naming
  the op and the source line (origin filtering: consumers of a flagged
  value are not flagged again);
* clean programs: every registry sampler, the real deployable round body
  and the zoo round body (``fed.round.scan_body_for_lint``, its
  ``vmap(grad)`` with the recompute of ``remat="full"`` inside), the
  segment runner, the serve engine's decode step and swaps; the CLI's exit
  codes on one sampler with ``--fast``; ``launch.train --lint`` exits 1 on
  a finding before it trains; ``api.lint``.

The whole-registry sweep (``python -m repro_torch.analysis.lint --fast``,
244 checks) runs in ``chip_smoke.py``'s "lint" phase.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.lint import (  # noqa: E402
    Finding,
    LintReport,
    audit_compile_once,
    audit_dtypes,
    audit_scan_safety,
    audit_width,
    main,
    run_suite,
    trace,
)
from repro_torch.core import samplers  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402

N = 13  # distinctive client count: prime, collides with no model dimension
D = 60


def _spec(**exec_kw):
    return api.ExperimentSpec(
        task=api.TaskSpec(name="logreg", dataset="synthetic_classification",
                          dataset_kwargs={"n_clients": N, "total": 40 * N, "seed": 0}),
        sampler=api.SamplerSpec(name="kvib", kwargs={"horizon": 4}),
        federation=api.FederationSpec(rounds=4, budget=4, local_steps=1, batch_size=8),
        execution=api.ExecutionSpec(**exec_kw),
    )


def _zoo_spec(**federation):
    return api.ExperimentSpec.from_dict({
        "task": {"kind": "zoo", "name": "smollm-360m", "reduced": True,
                 "kwargs": {"n_layers": 1, "d_model": 32, "d_ff": 64, "vocab": 64},
                 "dataset": "synthetic_tokens",
                 "dataset_kwargs": {"n_clients": N, "seq_len": 16, "total_seqs": 256}},
        "sampler": {"name": "kvib", "kwargs": {"horizon": 3}},
        "federation": {"rounds": 3, "budget": 2, "cohort": 3, "local_steps": 1,
                       "batch_size": 2, "local_lr": 0.05, **federation},
        "execution": {"seed": 5},
    })


def _vec(n=N):
    return torch.empty(n, dtype=torch.float32, device="meta")


# ---------------------------------------------------------------------------
# Seeded violations: exactly one finding each, right op, real provenance
# ---------------------------------------------------------------------------


def test_seeded_ond_body_yields_exactly_one_width_finding():
    """An outer product making (N, D) is flagged once, at the multiply that
    introduces it; the sum consuming it is suppressed."""

    def bad_body(fb, delta):
        contrib = fb[:, None] * delta[None, :]  # the O(N*D) leak
        return contrib.sum(0)

    findings = audit_width(trace(bad_body, _vec(), _vec(D)), N, target="bad_body")
    assert len(findings) == 1, "\n".join(f.render() for f in findings)
    (f,) = findings
    assert f.check == "width" and f.op == "mul" and f.shape == f"float32[{N},{D}]"
    assert "test_torch_lint.py" in f.provenance and "bad_body" in f.provenance


def test_width_auditor_allows_n_vectors_and_integer_buffers():
    def fine_body(p, idx):
        fb = p * 2.0  # (N,) float
        keys = idx[:, None, None].expand(N, 3, 2) + 1  # (N, 3, 2) integer
        return fb.sum() + keys.sum()

    gm = trace(fine_body, _vec(), torch.empty(N, dtype=torch.int64, device="meta"))
    assert audit_width(gm, N) == []


def test_width_auditor_allowlist_permits_declared_buffers():
    gm = trace(lambda fb, delta: fb[:, None] * delta[None, :], _vec(), _vec(D))
    assert audit_width(gm, N, allow=[(N, D)]) == []
    assert len(audit_width(gm, N)) == 1


def test_seeded_host_sync_sampler_yields_exactly_one_scan_safety_finding():
    """A sampler reading a value to the host in update() is refused once,
    naming the read and the method."""

    @dataclasses.dataclass(frozen=True)
    class SpySampler(samplers.Sampler):
        def update(self, state, draw, feedback):
            if feedback.sum().item() > 0:  # one device-to-host read a round
                pass
            return dataclasses.replace(state, t=state.t + 1)

    findings = audit_scan_safety(SpySampler(n=N, budget=4))
    assert len(findings) == 1, "\n".join(f.render() for f in findings)
    (f,) = findings
    assert f.check == "scan_safety" and f.op == "_local_scalar_dense"
    assert f.target.endswith(".update") and "host sync" in f.message
    assert "test_torch_lint.py" in f.provenance and "update" in f.provenance


def test_seeded_f64_leak_yields_exactly_one_dtype_finding():
    """A float64 cast is flagged once, where it happens; the arithmetic
    consuming it is not."""

    def leaky(x):
        y = x.to(torch.float64)
        return (y * 2.0).sum()

    findings = audit_dtypes(trace(leaky, _vec()), target="leaky")
    assert len(findings) == 1, "\n".join(f.render() for f in findings)
    (f,) = findings
    assert f.check == "dtype" and f.op == "_to_copy" and f.shape == f"float64[{N}]"
    assert "test_torch_lint.py" in f.provenance and "leaky" in f.provenance


def test_f64_sites_are_allowed_by_name_only():
    """The RSP draw's f64 prefix sums pass as a site by design; the same
    code under another function name is a finding."""
    probs = torch.full((N,), 1.0 / N)
    u = torch.rand(4)
    assert audit_dtypes(trace(lambda u, p: samplers._rsp_wr_draw(u, p, 4), u, probs)) == []

    def copied(u, p):
        cum = torch.cumsum(p, 0, dtype=torch.float64).to(torch.float32)
        return torch.searchsorted(cum, cum[-1] * (1.0 - u))

    (f,) = audit_dtypes(trace(copied, u, probs))
    assert f.op == "cumsum" and "copied" in f.provenance


def test_data_dependent_control_flow_surfaces_as_finding():
    @dataclasses.dataclass(frozen=True)
    class BranchySampler(samplers.Sampler):
        def probabilities(self, state):
            if state.stats[0] > 0:  # bool(tensor): a host read
                return torch.full((self.n,), 0.5)
            return torch.full((self.n,), self.budget / self.n)

    findings = audit_scan_safety(BranchySampler(n=N, budget=4))
    assert len(findings) == 1, "\n".join(f.render() for f in findings)
    (f,) = findings
    assert f.check == "scan_safety" and f.target.endswith(".probabilities")
    assert "control flow" in f.message and "probabilities" in f.provenance


def test_data_dependent_shape_surfaces_as_finding():
    @dataclasses.dataclass(frozen=True)
    class ListSampler(samplers.Sampler):
        def update(self, state, draw, feedback):
            picked = torch.nonzero(draw.mask)[:, 0]  # as many rows as clients drawn
            stats = state.stats.index_add(0, picked, feedback[picked])
            return dataclasses.replace(state, stats=stats, t=state.t + 1)

    findings = audit_scan_safety(ListSampler(n=N, budget=4))
    assert len(findings) == 1, "\n".join(f.render() for f in findings)
    assert findings[0].target.endswith(".update") and "shape" in findings[0].message


def test_update_state_drift_surfaces_as_finding():
    """update() retyping a state leaf breaks the carry on the next round and
    at a checkpoint; the audit reports it at the sampler."""

    @dataclasses.dataclass(frozen=True)
    class DriftySampler(samplers.Sampler):
        def update(self, state, draw, feedback):
            return dataclasses.replace(state, t=(state.t + 1).to(torch.float32))

    findings = audit_scan_safety(DriftySampler(n=N, budget=4))
    assert len(findings) == 1
    assert "drifts state leaf t" in findings[0].message


def test_bad_probabilities_shape_surfaces_as_finding():
    @dataclasses.dataclass(frozen=True)
    class WideProbs(samplers.Sampler):
        def probabilities(self, state):
            return torch.full((self.n, 2), 0.5)

    findings = audit_scan_safety(WideProbs(n=N, budget=4))
    assert len(findings) == 1
    assert "probabilities must return" in findings[0].message


# ---------------------------------------------------------------------------
# Compile-once: built once, the carry stable under the checkpoint round trip
# ---------------------------------------------------------------------------


def _toy_segment(params0, rounds=6):
    from repro_torch.fed.state import TrainState, init_metric_buffers, make_segment_fn
    from repro_torch.rng import PhiloxSource

    def body(t, carry):
        p, opt, s = carry
        return (p + 1.0, opt, s), {"loss": torch.as_tensor(p).sum().to(torch.float32)}

    source = PhiloxSource(0, "cpu")
    seg = make_segment_fn(body, source)
    state = TrainState(params=params0, opt_state=(), sampler=torch.zeros(3),
                       metrics=init_metric_buffers({"loss": ((), torch.float32)}, rounds, "cpu"),
                       round=0, source=source.state_dict())
    return seg, state


def test_compile_once_clean_on_a_tensor_carry():
    seg, state = _toy_segment(torch.zeros(4))
    assert audit_compile_once(seg, state, 2) == []


def test_compile_once_flags_a_python_scalar_carry_on_resume():
    """A Python float in the carry survives segment boundaries but comes
    back from the numpy round trip as a float64 tensor: one finding."""
    seg, state = _toy_segment(1.0)
    findings = audit_compile_once(seg, state, 2)
    assert len(findings) == 1, "\n".join(f.render() for f in findings)
    (f,) = findings
    assert f.check == "compile_once" and "checkpoint resume" in f.message
    assert "float64" in f.message and "params" in f.message


def test_compile_once_flags_a_runner_rebuilt_per_segment():
    from repro_torch.fed.state import make_segment_fn

    seg, state = _toy_segment(torch.zeros(4))

    def rebuilding(st, n):  # builds a segment function every call
        make_segment_fn(lambda t, c: (c, {}), None)
        return seg(st, n)

    rebuilding._lint = seg._lint
    findings = audit_compile_once(rebuilding, state, 2, resume=False)
    assert len(findings) == 1 and "segment functions built" in findings[0].message
    (f,) = audit_compile_once(lambda st, n: seg(st, n), state, 2)
    assert "no lint handles" in f.message


def test_compile_once_clean_on_the_real_segment_runner():
    from repro_torch.fed.server import build_segment_runner

    built = api.build(_spec(oracle_metrics=False), "cpu")
    cfg = dataclasses.replace(built.fed_config, rounds=6)
    segment, state = build_segment_runner(built.task, built.dataset, built.sampler, cfg,
                                          device="cpu")
    assert audit_compile_once(segment, state, 2, target="segment") == []


# ---------------------------------------------------------------------------
# The registry, the suite, the front doors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", samplers.sampler_names())
def test_registered_samplers_are_scan_safe(name):
    s = samplers.make_sampler(name, n=N, budget=4)
    findings = audit_scan_safety(s, target=f"sampler:{name}")
    assert findings == [], "\n".join(f.render() for f in findings)


def test_run_suite_clean_on_the_deployable_compiled_spec():
    report = run_suite(_spec(compiled=True, oracle_metrics=False))
    assert report.ok, report.render()
    assert {c.split(":", 1)[0] for c in report.checked} == {
        "scan_safety", "dtype", "width", "compile_once"}


def test_run_suite_skips_width_on_oracle_and_scatter_bodies():
    for spec in (_spec(compiled=False, oracle_metrics=True),
                 _spec(compiled=False, oracle_metrics=False, exact_oracle_equiv=True)):
        report = run_suite(spec)
        assert report.ok, report.render()
        assert not any(c.startswith("width") for c in report.checked)


def test_run_suite_refuses_hlo():
    with pytest.raises(ValueError, match="HLO"):
        run_suite(_spec(), hlo=True)


def test_api_lint_forwards_to_run_suite():
    report = api.lint(_spec(compiled=False), compile_guard=False)
    assert isinstance(report, LintReport)
    assert report.ok, report.render()


def test_report_render_and_ok():
    rep = LintReport()
    rep.add([], "width:x")
    assert rep.ok and "clean" in rep.render()
    rep.add([Finding(check="width", target="t", message="boom", op="mul",
                     shape="float32[13,60]")], "width:y")
    assert not rep.ok
    text = rep.render()
    assert "1 finding" in text and "mul" in text and "boom" in text


def test_cli_single_sampler_fast_sweep_exit_codes(tmp_path, capsys):
    """``python -m repro_torch.analysis.lint``: 0 on a clean sweep or spec."""
    assert main(["--samplers", "uniform_isp", "--fast", "--quiet"]) == 0
    out = capsys.readouterr().out
    assert "lint clean" in out
    path = tmp_path / "spec.json"
    _spec(compiled=False).save(path)
    assert main(["--spec", str(path)]) == 0


# ---------------------------------------------------------------------------
# The zoo round body, the launcher, the serve engine
# ---------------------------------------------------------------------------


def test_zoo_body_lints_clean_and_makes_no_weights():
    """``scan_body_for_lint``: the round body's carry on ``meta`` (no
    weights made), traced with ``vmap(grad)`` and the recompute of
    ``remat="full"`` inside, clean; then an O(N*D) buffer planted in the
    round (the deltas scattered to all N clients) is one width finding."""
    from repro_torch.fed import round as zoo_round

    built = api.build(_zoo_spec(), "cpu")
    assert built.arch_config.remat == "full"
    _, (carry, _) = zoo_round.scan_body_for_lint(
        built.arch_config, built.round_spec, built.sampler, built.dataset)
    assert all(x.device.type == "meta" for x in tree_leaves(carry[0]))
    assert carry[2].stats.device.type == "meta"
    report = run_suite(built.spec)
    assert report.ok, report.render()
    assert {c.split(":", 1)[0] for c in report.checked} == {"scan_safety", "dtype", "width"}

    weighted = zoo_round.weighted_delta_sum

    def scattered(deltas, weights):
        def leaf(x):  # every client's row, zero outside the cohort: (N, ...)
            return x.new_zeros((N,) + x.shape[1:]).index_copy(0, torch.arange(x.shape[0]), x)

        full = _tree_map(leaf, deltas)
        return weighted(_tree_map(lambda f: f[: weights.shape[0]], full), weights)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(zoo_round, "weighted_delta_sum", scattered)
        findings = run_suite(built.spec).findings
    assert findings and {f.check for f in findings} == {"width"}
    assert all("in leaf" in f.provenance for f in findings)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def test_launch_train_lint_exits_on_a_finding(capsys, monkeypatch):
    """``launch.train --lint`` stops before round 0 with exit code 1 when
    the round body leaks a float64 (a clean spec lints, then trains: the
    card's "lint" phase of ``chip_smoke.py``)."""
    from repro_torch.fed import round as zoo_round
    from repro_torch.launch import train

    flags = ["--arch", "smollm-360m", "--reduced", "--rounds", "1", "--clients", str(N),
             "--budget", "2", "--cohort", "3", "--seq", "16", "--local-batch", "2",
             "--lint", "--device", "cpu"]
    mean_loss = zoo_round._cohort_mean_loss
    monkeypatch.setattr(zoo_round, "_cohort_mean_loss",
                        lambda losses, w: mean_loss(losses, w).double().float())
    with pytest.raises(SystemExit) as err:
        train.main(flags)
    assert err.value.code == 1
    text = capsys.readouterr().out
    assert "lint FAILED: 1 finding" in text and "round   0" not in text


def test_serve_engine_decode_graph_and_swap_probe():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = get_config("smollm-360m").reduced(n_layers=2, d_model=64, d_ff=128, vocab=64)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    variant = transformer.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    engine = ServeEngine(cfg, params, batch=2, max_seq=32, page_size=8, device="cpu")
    gm = engine.decode_graph()
    assert audit_dtypes(gm) == []
    assert any(lint._op_name(n) == "argmax" for n, _ in lint.iter_nodes(gm))
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(2))
    assert engine.compile_once_probe(prompts, [params, variant]) == []
    # A swap that rebinds a parameter instead of copying into it breaks the
    # engine's address promise: the probe says so.
    engine.swap_params = lambda new: engine._params.__setitem__("embed", new["embed"].clone())
    problems = engine.compile_once_probe(prompts, [params, variant], calls=1)
    assert problems and "parameter" in problems[0]
