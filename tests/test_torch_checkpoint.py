"""The port's checkpointing, TrainState and segmented runs.

Mirrors the reference's ``tests/test_checkpoint_manager.py`` (dtype,
structure and fingerprint guards, atomic publish, ``keep_last``,
``wait_for_next``, every sampler's state through a round trip) and
``tests/test_segmented_scan.py`` (segmented equals one segment; a run
preempted with ``max_segments`` and resumed from a fresh manager equals the
uninterrupted run bit for bit), on the port's own random source.  The
resumed run must draw what the uninterrupted run drew, so the Philox
generators' states ride ``TrainState.source``.  Also: ``exact_oracle_equiv``
at C = N is bitwise the oracle run, the score-history host offload gives
the full buffer's History, ``config_fingerprint`` equals the reference's.
"""
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import config_fingerprint as ref_fingerprint  # noqa: E402
from repro import api as ref_api  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    config_fingerprint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.core import samplers, stragglers  # noqa: E402
from repro_torch.fed.server import build_segment_runner, run_federated  # noqa: E402
from repro_torch.fed.state import TrainState, run_segmented  # noqa: E402
from repro_torch.rng import PhiloxSource, ReplaySource  # noqa: E402

ROUNDS = 6


# -- checkpointer --------------------------------------------------------------


def test_restore_rejects_dtype_mismatch(tmp_path):
    """Dtype drift raises like shape drift does; nothing is cast."""
    f = save_checkpoint(str(tmp_path / "c"), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(f, {"a": torch.zeros(3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(f, {"a": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(f, {"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(f, {"a": torch.zeros(4)})


def test_restore_compares_saved_treedef(tmp_path):
    """Same leaves, another structure: refused."""
    f = save_checkpoint(str(tmp_path / "c"), {"a": torch.zeros(3), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="treedef"):
        restore_checkpoint(f, {"a": torch.zeros(3), "z": torch.ones(3)})
    with pytest.raises(ValueError, match="treedef"):
        restore_checkpoint(f, (torch.zeros(3), torch.ones(3)))


def test_save_publishes_atomically_no_stray_tmp(tmp_path):
    save_checkpoint(str(tmp_path / "c"), {"a": torch.zeros(2)})
    assert sorted(os.listdir(tmp_path)) == ["c.npz", "c.treedef.txt"]


def test_nested_state_round_trips_with_every_leaf_kind(tmp_path):
    """Dataclasses, named tuples, tuples, lists, scalars and the dtypes numpy
    lacks (bf16, fp8: stored as raw bits) come back equal, in their types."""
    state = TrainState(
        params={"w": torch.randn(3, 2), "b": torch.zeros(2, dtype=torch.bfloat16)},
        opt_state=(),
        sampler=samplers.SamplerState(
            stats=torch.rand(4), aux=torch.rand(4), t=torch.tensor(3, dtype=torch.int32)
        ),
        metrics={"loss": torch.arange(5, dtype=torch.float32)},
        round=7,
        source=PhiloxSource(2, "cpu").state_dict(),
        faults={"buf": {"delta": torch.randn(2, 8).to(torch.float8_e4m3fn),
                        "valid": torch.tensor([True, False])}},
        compression=[1.5, torch.ones(1)],
    )
    template = dataclasses.replace(
        state,
        params={"w": torch.zeros(3, 2), "b": torch.ones(2, dtype=torch.bfloat16)},
        sampler=samplers.SamplerState(
            stats=torch.zeros(4), aux=torch.zeros(4), t=torch.tensor(0, dtype=torch.int32)
        ),
        metrics={"loss": torch.zeros(5)},
        round=0,
        source=PhiloxSource(9, "cpu").state_dict(),
        faults={"buf": {"delta": torch.zeros(2, 8, dtype=torch.float8_e4m3fn),
                        "valid": torch.tensor([False, False])}},
        compression=[0.0, torch.zeros(1)],
    )
    got = restore_checkpoint(save_checkpoint(str(tmp_path / "c"), state), template)
    assert isinstance(got, TrainState) and isinstance(got.sampler, samplers.SamplerState)
    assert got.round == 7 and isinstance(got.round, int)
    assert got.compression[0] == 1.5 and isinstance(got.compression, list)
    for a, b in zip(tree_flatten(got), tree_flatten(state)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a,
                               b.view(torch.uint8) if b.dtype == torch.float8_e4m3fn else b)
        else:
            assert a == b


# -- CheckpointManager -----------------------------------------------------------


def _state(x=0.0):
    return {"w": torch.full((4,), x), "t": torch.tensor(0, dtype=torch.int32)}


def test_manager_save_latest_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest() is None and mgr.read_manifest() is None
    mgr.save(_state(1.0), step=2)
    mgr.save(_state(2.0), step=4)
    assert mgr.latest() == 4
    manifest = mgr.read_manifest()
    assert manifest["step"] == 4 and manifest["steps"] == [2, 4] and manifest["format"] == 1
    assert "torch" in manifest["versions"] and "numpy" in manifest["versions"]
    assert torch.equal(mgr.restore(_state())["w"], torch.full((4,), 2.0))
    assert torch.equal(mgr.restore(_state(), step=2)["w"], torch.full((4,), 1.0))


def test_manager_restore_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    template = _state(7.0)
    state, step = mgr.restore_or_init(template)
    assert step == 0 and state is template
    mgr.save(_state(3.0), step=5)
    state, step = mgr.restore_or_init(_state())
    assert step == 5 and torch.equal(state["w"], torch.full((4,), 3.0))


def test_manager_retention_keep_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=2)
    for step in (1, 2, 3, 4):
        mgr.save(_state(float(step)), step=step)
    assert mgr.read_manifest()["steps"] == [3, 4]
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "manifest.json",
        "state_00000003.npz", "state_00000003.treedef.txt",
        "state_00000004.npz", "state_00000004.treedef.txt",
    ]
    assert mgr.latest() == 4
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointManager(str(tmp_path / "x"), keep_last=0)


def test_manager_config_fingerprint_guard(tmp_path):
    fp_a = config_fingerprint({"rounds": 10, "seed": 0})
    fp_b = config_fingerprint({"rounds": 20, "seed": 0})
    assert fp_a != fp_b and fp_a == config_fingerprint({"seed": 0, "rounds": 10})
    CheckpointManager(str(tmp_path / "ck"), fingerprint=fp_a).save(_state(), step=1)
    with pytest.raises(ValueError, match="fingerprint"):
        CheckpointManager(str(tmp_path / "ck"), fingerprint=fp_b).restore(_state())
    CheckpointManager(str(tmp_path / "ck"), fingerprint=fp_a).restore(_state())


def test_manager_treedef_hash_guard(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(_state(), step=1)
    with pytest.raises(ValueError, match="treedef"):
        mgr.restore({"w": torch.zeros(4), "u": torch.tensor(0, dtype=torch.int32)})


def test_manager_manifest_is_commit_point(tmp_path):
    """A file without a manifest entry is unreachable; a manifest entry whose
    file is gone falls back to an older retained step."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(_state(1.0), step=2)
    save_checkpoint(mgr.checkpoint_path(9), _state(9.0))
    assert mgr.latest() == 2
    got, step = mgr.restore_or_init(_state())
    assert step == 2 and torch.equal(got["w"], torch.full((4,), 1.0))
    mgr.save(_state(3.0), step=4)
    os.remove(mgr.checkpoint_path(4))
    assert mgr.latest() == 2


def test_wait_for_next_returns_newly_committed_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.wait_for_next(0, timeout=0.05) is None
    mgr.save(_state(1.0), step=2)
    assert mgr.wait_for_next(0, timeout=0.05) == 2
    assert mgr.wait_for_next(2, timeout=0.05) is None
    assert mgr.wait_for_next(0, timeout=0.0) == 2
    assert mgr.wait_for_next(2, timeout=0.0) is None


def test_wait_for_next_against_concurrent_writer(tmp_path):
    """A reader polling while a writer thread publishes sees a strictly
    increasing step sequence and restores complete state at every step."""
    path = str(tmp_path / "ck")
    steps = [2, 4, 6, 8, 10]
    writer_mgr = CheckpointManager(path, keep_last=len(steps))

    def writer():
        for s in steps:
            writer_mgr.save(_state(float(s)), step=s)
            time.sleep(0.02)

    reader = CheckpointManager(path)
    t = threading.Thread(target=writer)
    t.start()
    seen, after = [], 0
    while after < steps[-1]:
        step = reader.wait_for_next(after, timeout=5.0, poll_interval=0.005)
        assert step is not None and step > after, f"writer stalled after {seen}"
        got = reader.restore(_state(), step=step)
        assert torch.equal(got["w"], torch.full((4,), float(step)))
        seen.append(step)
        after = step
    t.join()
    assert seen[-1] == steps[-1] and set(seen) <= set(steps)


def _advance(s, state, source, t0, rounds, n):
    fb_full = torch.linspace(0.1, 1.0, n)
    probs = []
    for t in range(t0, t0 + rounds):
        p = s.probabilities(state)
        draw = s.sample_from(p, samplers.draw_input(source, s.procedure, t, n, s.budget))
        state = s.update(state, draw, fb_full * draw.mask)
        probs.append(p.clone())
    return state, probs


@pytest.mark.parametrize("name", samplers.sampler_names())
def test_sampler_state_survives_checkpoint_round_trip(name, tmp_path):
    """3 rounds, save (sampler state and the source's generators), restore
    into fresh templates, 5 more rounds: bitwise the 8 rounds without the
    round trip."""
    n, k = 16, 4
    kw = {"cluster_ids": tuple(i % 4 for i in range(n))} if name == "clustered_kvib" else {}
    s = samplers.make_sampler(name, n=n, budget=k, **kw)
    src = PhiloxSource(0, "cpu")
    state, _ = _advance(s, s.init("cpu"), src, 0, 3, n)
    samplers.assert_serializable_state(state)
    mgr = CheckpointManager(str(tmp_path / name))
    mgr.save({"sampler": state, "source": src.state_dict()}, step=3)
    fresh_src = PhiloxSource(0, "cpu")
    restored, step = mgr.restore_or_init({"sampler": s.init("cpu"), "source": fresh_src.state_dict()})
    assert step == 3
    fresh_src.load_state_dict(restored["source"])
    cont, p_cont = _advance(s, restored["sampler"], fresh_src, 3, 5, n)
    ref, p_ref = _advance(s, state, src, 3, 5, n)
    assert all(torch.equal(a, b) for a, b in zip(p_cont, p_ref))
    for a, b in zip(tree_flatten(cont), tree_flatten(ref)):
        assert torch.equal(a, b), name


def test_philox_state_dict_resumes_every_stream():
    """load_state_dict puts every stream, the late ones included, where
    state_dict took it; a ReplaySource's state is empty."""
    a = PhiloxSource(3, "cpu")
    a.isp_uniforms(0, 5)
    a.rsp_wor_indices(0, 9, 3)
    st = a.state_dict()
    assert set(st) == {"init", "sample", "cohort", "data", "avail", "latency", "async",
                       "gumbel", "rsp", "rsp_wor"}
    assert all(v.dtype == torch.uint8 and v.device.type == "cpu" for v in st.values())
    b = PhiloxSource(99, "cpu")
    b.load_state_dict(st)
    assert torch.equal(a.isp_uniforms(1, 5), b.isp_uniforms(1, 5))
    assert torch.equal(a.rsp_wor_indices(1, 9, 3), b.rsp_wor_indices(1, 9, 3))
    assert torch.equal(a.rsp_uniforms(1, 4), b.rsp_uniforms(1, 4))
    assert torch.equal(a.latencies(1, (6,), "exponential"), b.latencies(1, (6,), "exponential"))
    assert ReplaySource().state_dict() == {}


@pytest.mark.parametrize("section", [{}, {"fault": {"deadline": 2.0}},
                                     {"compression": {"delta_dtype": "int8"}},
                                     {"execution": {"ckpt_every": 3, "sampler_axis": "data"}}])
def test_config_fingerprint_matches_reference(section):
    d = {"task": {"dataset_kwargs": {"n_clients": 8, "total": 320}}, **section}
    ref_spec = ref_api.ExperimentSpec.from_dict(d)
    spec = api.ExperimentSpec.from_json(ref_spec.to_json())
    assert config_fingerprint(spec) == ref_fingerprint(ref_spec)
    assert config_fingerprint(spec.to_dict()) == ref_fingerprint(ref_spec.to_dict())


def test_abstract_fault_state_is_meta():
    fault = api.FaultSpec(availability="markov", async_buffer=3)
    st = stragglers.abstract_fault_state(fault, 7, 11, api.CompressionSpec(delta_dtype="int8"))
    real = stragglers.fault_state_init(fault, 7, 11, api.CompressionSpec(delta_dtype="int8"), "cpu")
    flat, want = tree_flatten(st), tree_flatten(real)
    assert len(flat) == len(want)
    for a, b in zip(flat, want):
        assert a.device.type == "meta" and a.shape == b.shape and a.dtype == b.dtype


# -- segmented runs, preemption and resume --------------------------------------


def spec_dict(name="kvib", *, rounds=ROUNDS, ckpt_every=0, **sections):
    """A small logreg spec: N=12, K=4, with sections' fields merged in."""
    d = {
        "task": {"name": "logreg", "dataset": "synthetic_classification",
                 "dataset_kwargs": {"n_clients": 12, "total": 600, "seed": 7}},
        "sampler": {"name": name, "kwargs": {"horizon": rounds} if name in ("kvib", "vrb") else {}},
        "federation": {"rounds": rounds, "budget": 4, "local_steps": 2, "batch_size": 16,
                       "local_lr": 0.05, "eval_every": 2},
        "execution": {"seed": 5, "ckpt_every": ckpt_every},
    }
    for k, v in sections.items():
        d[k] = {**d.get(k, {}), **v}
    return d


def _spec(*args, **kw):
    return api.ExperimentSpec.from_dict(spec_dict(*args, **kw))


def _eval(device):
    ds = api.build(_spec(), device).dataset
    x, y = ds.batch_all_clients(4, generator=torch.Generator(device=device).manual_seed(9))
    return x.reshape(-1, x.shape[-1]), y.reshape(-1)


def histories_equal(a, b):
    assert a.rounds == b.rounds
    assert a.train_loss == b.train_loss
    assert a.cohort_size == b.cohort_size
    assert a.cohort_dropped == b.cohort_dropped
    assert a.deadline_dropped == b.deadline_dropped
    assert a.estimator_sq_error == b.estimator_sq_error
    assert a.test_accuracy == b.test_accuracy
    if a.regret is not None and a.regret.costs:
        assert a.regret.costs == b.regret.costs and a.regret.opt_costs == b.regret.opt_costs
        if a.regret.score_history:
            np.testing.assert_array_equal(
                np.stack(a.regret.score_history), np.stack(b.regret.score_history)
            )
    for x, y in zip(tree_flatten(a.final_params), tree_flatten(b.final_params)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ckpt_every", [1, 3, 4, ROUNDS])
def test_segmented_bitwise_identical_to_one_segment(ckpt_every):
    ev = _eval("cpu")
    mono = api.run(_spec(), "cpu", eval_data=ev)
    seg = api.run(_spec(ckpt_every=ckpt_every), "cpu", eval_data=ev)
    assert len(mono.test_accuracy) == 4  # rounds 0, 2, 4 and 5
    histories_equal(seg, mono)


@pytest.mark.parametrize("name", ["vrb", "uniform_rsp"])
def test_segmented_identity_rsp_procedures(name):
    histories_equal(api.run(_spec(name, ckpt_every=4), "cpu"), api.run(_spec(name), "cpu"))


def test_segmented_identity_deployable_cohort():
    ex = {"oracle_metrics": False}
    fed = {"cohort": 3}
    a = api.run(_spec(ckpt_every=4, execution=ex, federation=fed), "cpu")
    b = api.run(_spec(execution=ex, federation=fed), "cpu")
    assert sum(a.cohort_dropped) > 0
    histories_equal(a, b)


def test_segment_runner_state_advances():
    """Round, source state and metric rows advance segment by segment."""
    built = api.build(_spec(), "cpu")
    segment, st0 = build_segment_runner(
        built.task, built.dataset, built.sampler, built.fed_config, device="cpu"
    )
    assert st0.round == 0 and st0.metrics["train_loss"].shape == (ROUNDS,)
    src0 = {k: v.clone() for k, v in st0.source.items()}
    st = segment(st0, 2)
    assert st.round == 2
    assert not torch.equal(st.source["sample"], src0["sample"])
    loss = st.metrics["train_loss"]
    assert bool((loss[:2] != 0).all()) and bool((loss[2:] == 0).all())
    st = segment(st, ROUNDS - 2)
    assert st.round == ROUNDS and bool((st.metrics["train_loss"] != 0).all())


# (name, sections): an ISP and RSP samplers, deployable mode, the fault layer
# and int8 + error feedback.
RESUME_CASES = {
    "kvib": ("kvib", {}),
    "uniform_rsp": ("uniform_rsp", {}),
    "vrb": ("vrb", {}),
    "deployable": ("kvib", {"execution": {"oracle_metrics": False}, "federation": {"cohort": 3}}),
    "markov_deadline_async": (
        "vrb", {"execution": {"oracle_metrics": False},
                "fault": {"availability": "markov", "availability_kwargs": {"p_on": 0.6, "p_off": 0.3},
                          "deadline": 1.2, "async_buffer": 3}}),
    "int8_ef": ("kvib", {"compression": {"delta_dtype": "int8"}}),
    "int8_ef_bernoulli_async": (
        "kvib", {"compression": {"delta_dtype": "int8"},
                 "fault": {"availability": "bernoulli", "availability_kwargs": {"q": 0.7},
                           "async_buffer": 3}}),
}


def preempt_and_resume(spec, device, root, eval_data=None):
    """(uninterrupted History, resumed History, uninterrupted TrainState,
    resumed TrainState): one segment run with a manager, then a fresh
    manager on the same directory resumes through ``api.run`` and through
    ``run_segmented``."""
    full = api.run(spec, device, eval_data=eval_data)
    built = api.build(spec, device)
    cfg = built.fed_config
    fp = config_fingerprint(spec)

    def runner():
        return build_segment_runner(
            built.task, built.dataset, built.sampler, cfg, eval_data, device=device
        )

    segment, st0 = runner()
    full_state = run_segmented(st0, cfg.rounds, segment, ckpt_every=cfg.ckpt_every)
    mgr = CheckpointManager(str(root), fingerprint=fp)
    segment, st0 = runner()
    pre = run_segmented(st0, cfg.rounds, segment, ckpt_every=cfg.ckpt_every, manager=mgr,
                        max_segments=1)
    assert pre.round == cfg.ckpt_every and mgr.latest() == cfg.ckpt_every
    segment, template = runner()
    restored, step = CheckpointManager(str(root), fingerprint=fp).restore_or_init(template)
    assert step == cfg.ckpt_every and restored.round == step
    resumed_state = run_segmented(restored, cfg.rounds, segment, ckpt_every=cfg.ckpt_every)
    # Back to the first boundary, then the front door resumes from it.
    mgr.save(pre, step=cfg.ckpt_every)
    resumed = api.run(spec, device, eval_data=eval_data,
                      ckpt_manager=CheckpointManager(str(root), fingerprint=fp))
    assert CheckpointManager(str(root)).latest() == cfg.rounds
    return full, resumed, full_state, resumed_state


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_preempt_resume_bitwise(case, tmp_path):
    name, sections = RESUME_CASES[case]
    spec = _spec(name, ckpt_every=2, **sections)
    full, resumed, full_state, resumed_state = preempt_and_resume(spec, "cpu", tmp_path / "ck")
    histories_equal(resumed, full)
    assert resumed_state.round == full_state.round == ROUNDS
    for a, b in zip(tree_flatten(resumed_state), tree_flatten(full_state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    if "fault" in sections:
        assert full.deadline_dropped == [] or sum(full.deadline_dropped) > 0


def _tiny_lm_spec():
    return api.ExperimentSpec.from_dict({
        "task": {"name": "tiny_lm", "kwargs": {"vocab": 64, "d_model": 32, "n_layers": 1},
                 "dataset": "synthetic_tokens",
                 "dataset_kwargs": {"n_clients": 10, "seq_len": 16, "vocab": 64,
                                    "total_seqs": 300, "power": 2.2, "seed": 0}},
        "sampler": {"name": "kvib", "kwargs": {"horizon": 4}},
        "federation": {"rounds": 4, "budget": 3, "local_steps": 1, "batch_size": 4,
                       "local_lr": 0.3, "cohort": 4},
        "execution": {"seed": 1, "oracle_metrics": False, "ckpt_every": 2},
    })


def test_tiny_lm_runs_repeat_and_resume_bitwise(tmp_path):
    """The tiny LM's embedding gradient sums repeated tokens in a fixed
    order (``F.embedding``), so two runs of one spec are bitwise equal and
    a resumed run equals the uninterrupted one."""
    spec = _tiny_lm_spec()
    a, b = api.run(spec, "cpu"), api.run(spec, "cpu")
    histories_equal(a, b)
    full, resumed, _, _ = preempt_and_resume(spec, "cpu", tmp_path / "ck")
    histories_equal(resumed, full)
    histories_equal(full, a)


def test_resume_with_eval_data(tmp_path):
    """The accuracy buffer is allocated before round 0 and rides the state."""
    ev = _eval("cpu")
    full, resumed, _, _ = preempt_and_resume(_spec(ckpt_every=2), "cpu", tmp_path / "ck", ev)
    assert len(full.test_accuracy) == 4
    histories_equal(resumed, full)


def test_run_federated_rejects_manager_without_segments(tmp_path):
    with pytest.raises(ValueError, match="ckpt_every"):
        api.run(_spec(), "cpu", ckpt_manager=CheckpointManager(str(tmp_path / "ck")))


def test_compiled_false_has_no_train_state(tmp_path):
    spec = _spec(ckpt_every=2, execution={"compiled": False})
    with pytest.raises(ValueError, match="compiled"):
        api.run(spec, "cpu", ckpt_manager=CheckpointManager(str(tmp_path / "ck")))
    with pytest.raises(ValueError, match="compiled"):
        api.restore_template(spec, device="cpu")


def test_run_segmented_errors():
    built = api.build(_spec(), "cpu")
    segment, st0 = build_segment_runner(
        built.task, built.dataset, built.sampler, built.fed_config, device="cpu"
    )
    with pytest.raises(ValueError, match="manager"):
        run_segmented(st0, ROUNDS, segment, publish=lambda s, d: None)
    with pytest.raises(ValueError, match="past the horizon"):
        run_segmented(dataclasses.replace(st0, round=ROUNDS + 1), ROUNDS, segment)


def test_run_segmented_hook_order(tmp_path):
    """save, then publish, then on_segment, then the max_segments check."""
    built = api.build(_spec(), "cpu")
    segment, st0 = build_segment_runner(
        built.task, built.dataset, built.sampler, built.fed_config, device="cpu"
    )
    events = []

    class Mgr(CheckpointManager):
        def save(self, state, step):
            events.append(("save", step))
            return super().save(state, step)

    st = run_segmented(
        st0, ROUNDS, segment, ckpt_every=2, manager=Mgr(str(tmp_path / "ck")),
        publish=lambda s, d: events.append(("publish", d)),
        on_segment=lambda s, d: events.append(("on_segment", d)), max_segments=2,
    )
    assert st.round == 4
    assert events == [("save", 2), ("publish", 2), ("on_segment", 2),
                      ("save", 4), ("publish", 4), ("on_segment", 4)]


def test_restore_template_round_trips(tmp_path):
    spec = _spec("vrb", ckpt_every=3, fault={"availability": "markov", "async_buffer": 2})
    template = api.restore_template(spec, device="cpu")
    assert isinstance(template, TrainState) and template.round == 0
    assert set(template.metrics) == {"train_loss", "cohort_size", "sq_error", "cost",
                                     "opt_cost", "scores"}
    mgr = CheckpointManager(str(tmp_path / "ck"), fingerprint=config_fingerprint(spec))
    api.run(spec, "cpu", ckpt_manager=mgr)
    assert mgr.read_manifest()["config_fingerprint"] == config_fingerprint(spec)
    got, step = mgr.restore_or_init(api.restore_template(spec, device="cpu"))
    assert step == ROUNDS and got.round == ROUNDS
    again = restore_checkpoint(
        save_checkpoint(str(tmp_path / "again"), got), api.restore_template(spec, device="cpu")
    )
    for a, b in zip(tree_flatten(again), tree_flatten(got)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_run_records_sampler_layout(tmp_path):
    spec = _spec(ckpt_every=3, execution={"sampler_axis": "data"})
    mgr = CheckpointManager(str(tmp_path / "ck"))
    api.run(spec, "cpu", ckpt_manager=mgr)
    layout = mgr.read_manifest()["shard_layout"]
    assert layout is not None and layout["axis"] == "data"


# -- exact_oracle_equiv and the score-history offload ---------------------------


@pytest.mark.parametrize("name", ["kvib", "uniform_isp", "uniform_rsp"])
def test_exact_oracle_equiv_bitwise_oracle(name):
    """Deployable at C = N with the N-width scatter: the oracle run's draws
    and parameter trajectory, bit for bit."""
    oracle = api.run(_spec(name), "cpu")
    dep = api.run(_spec(name, execution={"oracle_metrics": False, "exact_oracle_equiv": True},
                        federation={"cohort": 12}), "cpu")
    assert dep.cohort_size == oracle.cohort_size and dep.cohort_dropped == [0] * ROUNDS
    for a, b in zip(tree_flatten(dep.final_params), tree_flatten(oracle.final_params)):
        np.testing.assert_array_equal(a, b)


def test_exact_oracle_equiv_refuses_compression():
    spec = _spec(execution={"oracle_metrics": False, "exact_oracle_equiv": True},
                 compression={"delta_dtype": "int8"})
    with pytest.raises(ValueError, match="exact_oracle_equiv"):
        api.run(spec, "cpu")


@pytest.mark.parametrize("ckpt_every", [2, 4])
def test_score_history_offload_matches_full_buffer(ckpt_every):
    full = api.run(_spec(), "cpu")
    off = api.run(_spec(ckpt_every=ckpt_every,
                        execution={"score_history_host_offload": True}), "cpu")
    assert len(off.regret.score_history) == ROUNDS
    histories_equal(off, full)


def test_score_history_offload_device_ring_and_guard():
    spec = _spec(ckpt_every=2, execution={"score_history_host_offload": True})
    assert api.restore_template(spec, device="cpu").metrics["scores"].shape == (2, 12)
    with pytest.raises(ValueError, match="ckpt_every"):
        api.run(_spec(execution={"score_history_host_offload": True}), "cpu")
    built = api.build(_spec(), "cpu")
    cfg = dataclasses.replace(built.fed_config, score_history_bytes_limit=8)
    with pytest.raises(ValueError, match="score_history_bytes_limit"):
        run_federated(built.task, built.dataset, built.sampler, cfg, device="cpu")


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_preempt_resume_bitwise_on_card(case, cuda, tmp_path):
    """The card's Philox generators resume from their saved (seed, offset):
    the resumed card run is bitwise the uninterrupted card run."""
    name, sections = RESUME_CASES[case]
    spec = _spec(name, ckpt_every=2, **sections)
    full, resumed, full_state, resumed_state = preempt_and_resume(spec, cuda, tmp_path / "ck")
    histories_equal(resumed, full)
    for a, b in zip(tree_flatten(resumed_state), tree_flatten(full_state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.cuda
def test_tiny_lm_resume_bitwise_on_card(cuda, tmp_path):
    spec = _tiny_lm_spec()
    histories_equal(api.run(spec, cuda), api.run(spec, cuda))
    full, resumed, _, _ = preempt_and_resume(spec, cuda, tmp_path / "ck")
    histories_equal(resumed, full)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kvib", "uniform_rsp"])
def test_exact_oracle_equiv_on_card(name, cuda):
    """On the card the draws and cohorts equal the oracle run's; parameters
    are compared within f32 rounding (the cohort and the oracle run train
    under vmaps of other batch orders) and the largest gap is printed."""
    oracle = api.run(_spec(name), cuda)
    dep = api.run(_spec(name, execution={"oracle_metrics": False, "exact_oracle_equiv": True},
                        federation={"cohort": 12}), cuda)
    assert dep.cohort_size == oracle.cohort_size
    gap = 0.0
    for a, b in zip(tree_flatten(dep.final_params), tree_flatten(oracle.final_params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        gap = max(gap, float(np.abs(a - b).max()))
    print(f"exact_oracle_equiv {name}: largest parameter gap to the oracle run {gap:.3g}")


def test_manifest_json_is_plain(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), fingerprint="abc")
    mgr.save(_state(), step=1)
    with open(mgr.manifest_path) as f:
        m = json.load(f)
    assert m["config_fingerprint"] == "abc" and m["shard_layout"] is None
    assert m["file"] == "state_00000001.npz"
