"""The port's train-to-serve loop against the JAX reference on the CPU.

``repro_torch.serve``'s watcher, promotion gate and session, and the two
front doors (``launch.serve --follow`` and ``examples.fed_lm --serve``).
The reference's watcher cannot read the port's checkpoints (the port's
structure sidecar is JSON), so the watcher is held to the reference's
behaviour on the port's own manager; the gate and the session are held to
``repro.serve`` on the same weights (``transformer.params_from_reference``),
the same held-out batches (the reference's ``fold_in(PRNGKey(seed), 7)``
draws replayed) and scripted candidates.  Tests that run a trainer thread
assert only what holds under any interleaving of the two sides.
"""
import argparse
import json
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import synthetic_tokens as ref_synthetic_tokens  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import (  # noqa: E402
    Candidate as RefCandidate,
    PromotionGate as RefGate,
    ServeEngine as RefEngine,
    ServeSession as RefSession,
    ServeSummary as RefSummary,
    heldout_batches as ref_heldout_batches,
)
from repro_torch import api  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, config_fingerprint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import synthetic_tokens  # noqa: E402
from repro_torch.examples import fed_lm  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.rng import PhiloxSource  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Candidate,
    CheckpointWatcher,
    PromotionGate,
    PromotionLog,
    PromotionRecord,
    ServeEngine,
    ServeSession,
    ServeSummary,
    heldout_batches,
)
from test_torch_paper_examples import ref_example  # noqa: E402

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 held-out loss, XLA against ATen
ARCHS = {
    "smollm": ("smollm-360m", dict(n_layers=2, d_model=64, d_ff=128, vocab=64)),
    "ssm": ("zamba2-1.2b", dict(n_layers=4, vocab=64,
                                block_pattern=("mamba2", "mamba2", "mamba2", "shared_attn"))),
}
SUMMARY_RE = re.compile(
    r"^serve summary: promotions=(\d+) rollbacks=(\d+) tokens=(\d+) "
    r"tokens_per_sec=([\d.]+) swaps=(\d+) last_step=(\d+) batches=(\d+)$", re.M)


def _cfgs(arch="smollm"):
    name, kw = ARCHS[arch]
    return get_config(name).reduced(**kw), ref_get_config(name).reduced(**kw)


def _weights(arch="smollm", seed=0):
    """The reference's init for ``seed``, in both frameworks."""
    cfg, ref_cfg = _cfgs(arch)
    ref = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref, transformer.params_from_reference(jax.tree_util.tree_map(np.asarray, ref), cfg,
                                                  "cpu")


def _batches(n=2, b=2, s=12, vocab=64, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (b, s)).astype(np.int32),
             rng.integers(0, vocab, (b, s)).astype(np.int32)) for _ in range(n)]


# -- the watcher ----------------------------------------------------------------


def _state(scale: float):
    return {"params": {"w": torch.full((3, 2), float(scale)), "b": torch.zeros(2)},
            "round": 0}


def test_watcher_polls_the_newest_committed_step_once(tmp_path):
    mgr = CheckpointManager(str(tmp_path), fingerprint="f" * 16)
    w = CheckpointWatcher(CheckpointManager(str(tmp_path), fingerprint="f" * 16), _state(0),
                          extract=lambda s: s["params"])
    assert w.seen_step == 0 and w.poll() is None  # nothing committed yet
    for step in (1, 2, 3):
        mgr.save(_state(step), step)
    cand = w.poll()  # steps 1 and 2 are skipped, not queued
    assert isinstance(cand, Candidate) and cand.step == 3 and w.seen_step == 3
    assert torch.equal(cand.params["w"], torch.full((3, 2), 3.0))
    assert cand.state["params"] is cand.params and len(w.restore_seconds) == 1
    assert w.poll() is None and w.seen_step == 3  # each step surfaces once
    t0 = time.monotonic()
    assert w.wait(0.2) is None  # bounded
    assert 0.15 <= time.monotonic() - t0 < 2.0
    mgr.save(_state(4), 4)
    cand = w.wait(5.0)
    assert cand.step == 4 and w.seen_step == 4 and float(cand.params["w"][0, 0]) == 4.0
    # The default payload is ``.params``, or the state itself for a plain tree.
    cand = CheckpointWatcher(mgr, _state(0)).poll()
    assert cand.params is cand.state and torch.equal(cand.state["params"]["w"], cand.params["params"]["w"])
    assert CheckpointWatcher(mgr, _state(0)).extract(Candidate(step=1, params=5)) == 5


def test_watcher_wait_returns_once_a_trainer_commits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = CheckpointWatcher(mgr, _state(0))
    timer = threading.Timer(0.3, lambda: mgr.save(_state(7), 2))
    timer.start()
    try:
        cand = w.wait(10.0)
    finally:
        timer.join()
    assert cand.step == 2 and float(cand.state["params"]["w"][0, 0]) == 7.0


def test_watcher_refuses_a_foreign_run_and_another_structure(tmp_path):
    CheckpointManager(str(tmp_path), fingerprint="a" * 16).save(_state(1), 1)
    foreign = CheckpointWatcher(CheckpointManager(str(tmp_path), fingerprint="b" * 16), _state(0))
    with pytest.raises(ValueError, match="fingerprint"):
        foreign.poll()
    assert foreign.seen_step == 0  # a refused step is not marked seen
    other = {"params": {"w": torch.zeros(3, 2)}, "round": 0}  # no "b" leaf
    with pytest.raises(ValueError, match="treedef"):
        CheckpointWatcher(CheckpointManager(str(tmp_path), fingerprint="a" * 16), other).poll()
    reshaped = {"params": {"w": torch.zeros(2, 3), "b": torch.zeros(2)}, "round": 0}
    with pytest.raises(ValueError, match="shape"):
        CheckpointWatcher(CheckpointManager(str(tmp_path)), reshaped).poll()


# -- the gate ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_gate_score_matches_reference(arch):
    cfg, ref_cfg = _cfgs(arch)
    batches = _batches()
    ref_params, params = _weights(arch)
    want = RefGate(ref_cfg, batches).score(ref_params)
    gate = PromotionGate(cfg, batches, device="cpu")
    got = gate.score(params)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    assert gate.device == torch.device("cpu") and len(gate.score_seconds) == 1
    assert all(t.dtype == torch.int64 for b in gate.batches for t in b)
    # On the CPU the wrappers take their plain versions and count nothing.
    assert not any(gate.launches.values())


def _scripted_params():
    """Candidates of clearly different held-out loss: the reference's init
    for several keys, plus a copy of the incumbent (a tie promotes)."""
    return [_weights("smollm", seed) for seed in (0, 1, 2, 3, 0, 4)]


def test_gate_decisions_and_log_match_reference():
    cfg, ref_cfg = _cfgs()
    batches = _batches()
    weights = _scripted_params()
    for tolerance in (0.0, 0.01):
        ref = RefGate(ref_cfg, batches, tolerance=tolerance)
        gate = PromotionGate(cfg, batches, tolerance=tolerance, device="cpu")
        np.testing.assert_allclose(gate.prime(weights[0][1]), ref.prime(weights[0][0]), **SCORE_TOL)
        losses = []
        for step, (ref_p, p) in enumerate(weights[1:], start=1):
            want = ref.consider(RefCandidate(step=step, params=ref_p))
            assert gate.consider(Candidate(step=step, params=p)) == want
            losses.append(ref.log.records[-1].loss)
        # The scripted losses are apart by far more than the tolerance of
        # the comparison, so the decisions test the rule, not rounding.
        assert min(abs(a - b) for a in losses for b in losses if a != b) > 1e-4
        assert gate.log.render() == ref.log.render()
        assert (gate.log.promotions, gate.log.rollbacks) == (ref.log.promotions,
                                                             ref.log.rollbacks)
        np.testing.assert_allclose(gate.best_loss, ref.best_loss, **SCORE_TOL)
    assert 0 < gate.log.promotions < 5 and gate.log.rollbacks > 0


def test_gate_bookkeeping():
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="at least one held-out batch"):
        PromotionGate(cfg, [], device="cpu")
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _batches()]
    gate = PromotionGate(cfg, batches)  # tensors: the batches' device
    assert gate.device == torch.device("cpu") and gate.best_loss is None
    _, p0 = _weights()
    _, p1 = _weights(seed=1)
    assert gate.consider(Candidate(step=2, params=p1))  # unprimed: the bar is +inf
    rec = gate.log.records[0]
    assert rec == PromotionRecord(step=2, loss=rec.loss, best_loss=float("inf"), promoted=True)
    assert gate.best_loss == rec.loss and rec.reason == f"loss {rec.loss:.4f} <= best inf"
    worse = gate.score(p0) > rec.loss
    assert gate.consider(Candidate(step=4, params=p0)) == (not worse)
    assert gate.log.records[-1].best_loss == rec.loss and len(gate.score_seconds) == 3
    log = PromotionLog()
    log.append(PromotionRecord(step=6, loss=2.5, best_loss=2.0, promoted=False))
    log.append(PromotionRecord(step=8, loss=1.5, best_loss=2.0, promoted=True))
    assert log.render() == ("step    6 ROLLBACK (loss 2.5000 > best 2.0000)\n"
                            "step    8 PROMOTE (loss 1.5000 <= best 2.0000)\n"
                            "1 promotions, 1 rollbacks")


# -- the held-out batches --------------------------------------------------------------


DS_KW = dict(n_clients=6, seq_len=12, vocab=64, total_seqs=120, power=2.2, seed=0)


def _reference_draws(ds, n_batches, batch_size, seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    draws = []
    for _ in range(n_batches):
        key, k_client, k_rows = jax.random.split(key, 3)
        client = jax.random.randint(k_client, (), 0, ds.n_clients)
        draws.append((int(client), np.asarray(
            jax.random.randint(k_rows, (batch_size,), 0, ds.sizes[client]))))
    return draws


@pytest.mark.parametrize("seed", [0, 5])
def test_heldout_batches_replay_reference_draws(seed):
    ref_ds = ref_synthetic_tokens(**DS_KW)
    ds = synthetic_tokens(**DS_KW, device="cpu")
    want = ref_heldout_batches(ref_ds, n_batches=3, batch_size=4, seed=seed)
    got = heldout_batches(ds, n_batches=3, batch_size=4, seed=seed,
                          draws=_reference_draws(ref_ds, 3, 4, seed))
    assert len(got) == len(want) == 3
    for (t, y), (rt, ry) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    with pytest.raises(ValueError, match="held-out draws"):
        heldout_batches(ds, n_batches=2, batch_size=4, draws=_reference_draws(ref_ds, 3, 4, 0))


def test_heldout_batches_are_fixed_and_move_no_training_stream():
    ds = synthetic_tokens(**DS_KW, device="cpu")
    src = PhiloxSource(0, "cpu")
    before = {k: v.clone() for k, v in src.state_dict().items()}
    global_before = torch.get_rng_state()
    a = heldout_batches(ds, n_batches=4, batch_size=3, seed=0)
    b = heldout_batches(ds, n_batches=4, batch_size=3, seed=0)
    for (t, y), (t2, y2) in zip(a, b):
        assert torch.equal(t, t2) and torch.equal(y, y2)
        assert t.shape == (3, 12) and t.dtype == ds.features.dtype
    other = heldout_batches(ds, n_batches=4, batch_size=3, seed=1)
    assert any(not torch.equal(t, t2) for (t, _), (t2, _) in zip(a, other))
    after = src.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert torch.equal(global_before, torch.get_rng_state())
    # Rows stay below each client's size (the padded tail is never read).
    gen = serve.gate.serving_generator(0, serve.gate.HELDOUT_TAG)
    sizes = ds.sizes.tolist()
    for t, _ in a:
        client = int(torch.randint(0, ds.n_clients, (), generator=gen))
        rows = torch.randint(0, sizes[client], (3,), generator=gen)
        assert torch.equal(t, ds.features[client, rows])


# -- the session ---------------------------------------------------------------------


class ScriptedWatcher:
    """Surfaces ``script[i]`` (a candidate or None) at its i-th wait."""

    def __init__(self, script):
        self.script = list(script)
        self.seen_step = 0
        self.waits = 0

    def wait(self, timeout):
        cand = self.script[self.waits] if self.waits < len(self.script) else None
        self.waits += 1
        if cand is not None:
            self.seen_step = cand.step
        return cand


def _session_run(package: str, weights, prompts, batches):
    """One scripted session: candidates at the 1st, 3rd, 4th and 6th waits
    (steps 2, 4, 6, 8), greedy, 2 x (8 + 24) cache, 8 steps a chunk (so the
    batch refills).  Returns (summary, every generated token by batch)."""
    ref = package == "ref"
    cfg, ref_cfg = _cfgs()
    pick = 0 if ref else 1
    Cand = RefCandidate if ref else Candidate
    script = [Cand(step=2, params=weights[1][pick]), None, Cand(step=4, params=weights[2][pick]),
              Cand(step=6, params=weights[4][pick]), None, Cand(step=8, params=weights[3][pick])]
    if ref:
        engine = RefEngine(ref_cfg, weights[0][0], batch=2, max_seq=32, page_size=8)
        gate = RefGate(ref_cfg, batches)
    else:
        engine = ServeEngine(cfg, weights[0][1], batch=2, max_seq=32, page_size=8, device="cpu")
        gate = PromotionGate(cfg, batches, device="cpu")
    feed = iter(prompts)
    outputs = []

    def prompt_fn():
        if outputs or engine.index:
            outputs.append(np.asarray(engine.generated()))
        p = next(feed)
        return jnp.asarray(p) if ref else torch.from_numpy(p)

    sess = (RefSession if ref else ServeSession)(
        engine, ScriptedWatcher(script), gate, prompt_fn=prompt_fn, decode_steps_per_poll=8,
        final_step=8)
    summary = sess.run(timeout=120.0, poll_timeout=0.0)
    outputs.append(np.asarray(engine.generated()))
    return summary, outputs, gate


def test_session_matches_reference_on_scripted_candidates():
    weights = _scripted_params()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 64, (2, 8)).astype(np.int32) for _ in range(4)]
    batches = _batches()
    want, want_tokens, ref_gate = _session_run("ref", weights, prompts, batches)
    got, got_tokens, gate = _session_run("port", weights, prompts, batches)
    fields = ("promotions", "rollbacks", "tokens", "swaps", "last_step", "batches_served")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.last_step == 8 and got.batches_served == 2 and got.swaps == got.promotions
    assert got.promotions + got.rollbacks == 4 and got.rollbacks > 0 < got.promotions
    assert gate.log.render() == ref_gate.log.render()
    assert len(got_tokens) == len(want_tokens) == 2
    for g, w in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(g, w)
    assert torch.is_grad_enabled()  # the loop's no_grad does not leak


def test_summary_render_is_the_reference_line():
    kw = dict(tokens=1920, tokens_per_sec=412.345, promotions=2, rollbacks=1, swaps=2,
              last_step=6, batches_served=3)
    line = ServeSummary(**kw).render()
    assert line == RefSummary(**kw).render()
    assert SUMMARY_RE.match(line).groups() == ("2", "1", "1920", "412.3", "2", "6", "3")


# -- the front doors -------------------------------------------------------------------


def _follow_spec(rounds=3) -> api.ExperimentSpec:
    name, kw = ARCHS["smollm"]
    return api.ExperimentSpec.from_dict({
        "task": {"kind": "zoo", "name": name, "reduced": True, "kwargs": dict(kw),
                 "dataset": "synthetic_tokens",
                 "dataset_kwargs": {"n_clients": 6, "seq_len": 12, "total_seqs": 120}},
        "sampler": {"name": "kvib", "kwargs": {"horizon": rounds}},
        "federation": {"rounds": rounds, "budget": 2, "cohort": 3, "local_steps": 1,
                       "batch_size": 2, "local_lr": 0.5},
        "execution": {"seed": 0, "compiled": True, "ckpt_every": 1},
        "serve": {"batch": 2, "prompt_len": 8, "max_tokens": 16, "eval_batches": 2,
                  "decode_steps_per_poll": 4},
    })


def _assert_any_interleaving(summary, rounds, boundaries):
    assert summary.last_step == rounds
    assert summary.swaps == summary.promotions
    assert 1 <= summary.promotions + summary.rollbacks <= boundaries
    assert summary.tokens > 0 and summary.batches_served >= 1


def test_launch_serve_follows_a_training_thread(tmp_path, capsys):
    spec = _follow_spec()
    ckpt = tmp_path / "fl_ckpts"
    ckpt.mkdir()
    spec.save(str(ckpt / "spec.json"))  # the trainer's hand-off file
    manager = CheckpointManager(str(ckpt), fingerprint=config_fingerprint(spec.to_dict()))
    committed = []
    trainer = threading.Thread(
        target=api.run, args=(spec, "cpu"),
        kwargs=dict(ckpt_manager=manager, publish=lambda st, step: committed.append(step)))
    trainer.start()
    try:
        out = launch_serve.main(["--follow", str(ckpt), "--device", "cpu", "--timeout", "120",
                                 "--poll", "0.05"])
    finally:
        trainer.join(timeout=120)
    assert not trainer.is_alive() and committed == [1, 2, 3]
    summary = out["summary"]
    _assert_any_interleaving(summary, 3, 3)
    printed = capsys.readouterr().out
    m = SUMMARY_RE.search(printed)
    assert m and m.group(0) == summary.render()
    assert f"last_step=3" in m.group(0) and "gate bar (round-0 init)" in printed
    stats = json.loads(printed.split("follow stats ", 1)[1].splitlines()[0])
    assert len(stats["restore_s"]) == summary.promotions + summary.rollbacks
    assert len(stats["gate_s"]) == len(stats["restore_s"]) + 1  # prime + each decision
    assert out["engine"].device == torch.device("cpu")
    assert out["watcher"].seen_step == 3 and out["gate"].log.promotions == summary.promotions


def test_launch_serve_follow_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="spec.json"):
        launch_serve.main(["--follow", str(tmp_path), "--device", "cpu", "--timeout", "0.2"])
    task = api.ExperimentSpec.from_dict({
        "task": {"kind": "task", "name": "logreg", "dataset": "synthetic_classification",
                 "dataset_kwargs": {"n_clients": 4, "total": 80, "dim": 4}},
        "federation": {"rounds": 1, "budget": 1}})
    task.save(str(tmp_path / "task.json"))
    with pytest.raises(SystemExit, match="zoo"):
        launch_serve.main(["--follow", str(tmp_path), "--spec", str(tmp_path / "task.json"),
                           "--device", "cpu"])
    if not torch.cuda.is_available():
        _follow_spec().save(str(tmp_path / "spec.json"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve.main(["--follow", str(tmp_path)])


def test_follow_resumes_a_finished_run_and_refuses_a_changed_spec(tmp_path):
    """A run already finished: the server sees only its newest boundary;
    a spec that differs in one field is another run."""
    spec = _follow_spec(rounds=2)
    ckpt = tmp_path / "c"
    manager = CheckpointManager(str(ckpt), fingerprint=config_fingerprint(spec.to_dict()))
    api.run(spec, "cpu", ckpt_manager=manager)
    spec.save(str(ckpt / "spec.json"))
    out = launch_serve.main(["--follow", str(ckpt), "--device", "cpu", "--poll", "0"])
    assert out["summary"].last_step == 2 and len(out["gate"].log.records) == 1
    changed = api.ExperimentSpec.from_dict({**spec.to_dict(), "serve": {
        **spec.to_dict()["serve"], "tolerance": 0.5}})
    changed.save(str(tmp_path / "changed.json"))
    with pytest.raises(ValueError, match="fingerprint"):
        launch_serve.main(["--follow", str(ckpt), "--spec", str(tmp_path / "changed.json"),
                           "--device", "cpu", "--timeout", "5"])


SERVE_ARGV = ["--serve", "--rounds", "4", "--clients", "4", "--budget", "2", "--seq", "16",
              "--vocab", "64"]


def test_fed_lm_serve_spec_is_the_reference_spec(monkeypatch):
    mod = ref_example("fed_lm")
    args = fed_lm.parse_args(SERVE_ARGV)
    seen = []

    class Stop(Exception):
        pass

    def build(spec, *a, **k):
        seen.append(spec)
        raise Stop

    monkeypatch.setattr(ref_api, "build", build)
    with pytest.raises(Stop):
        mod.run_serve_demo(argparse.Namespace(**vars(args)))
    assert fed_lm.serve_spec(args).to_dict() == seen[0].to_dict()


def test_fed_lm_serve_on_the_cpu(capsys):
    out = fed_lm.main(SERVE_ARGV + ["--device", "cpu"])
    _assert_any_interleaving(out["summary"], 4, 2)
    printed = capsys.readouterr().out
    assert "[train] committed boundary step 2" in printed
    assert "[train] committed boundary step 4" in printed
    assert SUMMARY_RE.search(printed).group(0) == out["summary"].render()
    assert out["spec"].execution.ckpt_every == 2 and out["engine"].swaps == out["summary"].swaps


def test_exports_are_the_reference_names():
    import repro.serve as ref_serve

    assert sorted(serve.__all__) == sorted(ref_serve.__all__)


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(ARCHS))
def test_gate_on_card_matches_cpu_and_launches_kernels(arch, cuda):
    """The gate's f32 held-out loss on the card (kernels 6-8 forward) equals
    the CPU's, and its scoring launched the arch's kernels."""
    from repro_torch import kernels

    cfg, _ = _cfgs(arch)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batches = _batches()
    cpu = PromotionGate(cfg, batches, device="cpu").score(params)
    kernels.reset_launch_counts()
    gate = PromotionGate(cfg, batches, device=cuda)
    gpu = gate.score(_to(params, cuda))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=1e-5)
    want = {"rmsnorm", "flash_attention"} | ({"ssd_scan"} if arch == "ssm" else set())
    assert {k for k, v in gate.launches.items() if v} == want
    assert gate.launches == {k: v for k, v in kernels.launch_counts().items()}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_session_on_card_matches_cpu(cuda):
    """A scripted session on the card gives the CPU's decisions and greedy
    tokens (f32), and the engine's parameters keep their addresses."""
    cfg, _ = _cfgs()
    gen = torch.Generator().manual_seed(1)
    ws = [transformer.init_params(cfg, gen, "cpu") for _ in range(4)]
    prompts = [np.random.default_rng(k).integers(0, 64, (2, 8)).astype(np.int32) for k in range(3)]
    batches = _batches()
    runs = {}
    for dev in ("cpu", cuda):
        engine = ServeEngine(cfg, _to(ws[0], dev), batch=2, max_seq=32, page_size=8, device=dev)
        ptrs = [p.data_ptr() for p in tree_leaves(engine.params)]
        feed = iter(prompts)
        script = [Candidate(step=1, params=_to(ws[1], dev)), None,
                  Candidate(step=2, params=_to(ws[2], dev)),
                  Candidate(step=3, params=_to(ws[3], dev))]
        sess = ServeSession(engine, ScriptedWatcher(script),
                            PromotionGate(cfg, batches, device=dev),
                            prompt_fn=lambda: torch.from_numpy(next(feed)),
                            decode_steps_per_poll=8, final_step=3)
        summary = sess.run(poll_timeout=0.0)
        assert ptrs == [p.data_ptr() for p in tree_leaves(engine.params)]
        runs[str(dev)] = (summary, engine.generated().cpu(), sess.gate.log.render())
    (s_cpu, t_cpu, log_cpu), (s_gpu, t_gpu, log_gpu) = runs["cpu"], runs[str(cuda)]
    assert (s_gpu.promotions, s_gpu.rollbacks, s_gpu.swaps, s_gpu.last_step) == (
        s_cpu.promotions, s_cpu.rollbacks, s_cpu.swaps, s_cpu.last_step)
    assert [line.split(" (")[0] for line in log_gpu.splitlines()] == [
        line.split(" (")[0] for line in log_cpu.splitlines()]
    assert torch.equal(t_gpu, t_cpu)
