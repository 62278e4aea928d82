"""The port's zoo federated round against the JAX reference on the CPU.

``repro_torch.fed.round.build_round_step`` is held to
``repro.fed.round.build_round_step`` on the same weights (the reference's
``init_params`` tree through ``models.transformer.params_from_reference``),
tokens and cohort weights, in both round modes.  ``repro_torch.api.run``
with ``kind="zoo"`` replays the reference's own draws, recorded along its
key chain (``repro.api.runner._zoo_segment_and_state``: the parameters from
``PRNGKey(seed)`` itself, then ``key, k_draw, k_data = split(key, 3)`` a
round; the draw from ``k_draw``, the cohort priorities from
``fold_in(k_draw, 1)``, the fault variates from ``fold_in(k_draw,
101/102/103)`` with the latencies at width C, and client ``cid``'s batches
from ``split(fold_in(k_data, cid), R)``), and must follow
``repro.api.run`` round by round.  Reduced configs, f32: the reference's
``zoo_spec`` sizes (``tests/test_api_spec.py``) and a reduced zamba2 with
the pattern (mamba2, mamba2, mamba2, shared_attn); ``FAMILY_ARCHS`` (the
moe and xlstm families) go through the same checks in
``tests/test_torch_families_round.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.api import runner as ref_runner  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.fed import round as ref_round  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, config_fingerprint  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed import cohort, round as zoo_round  # noqa: E402
from repro_torch.fed.state import run_segmented  # noqa: E402
from repro_torch.fed.tasks import params_to_numpy, tree_leaves  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.rng import PhiloxSource, ReplaySource  # noqa: E402



@pytest.fixture(scope="module", autouse=True)
def one_intraop_thread():
    """These reduced models run thousands of small ops.  With several test
    workers on one machine, PyTorch's default of one intra-op thread a core
    makes every parallel op wait on threads of its own that another process
    holds: on 8 cores, six concurrent copies of one launcher test took 222 s
    each with the default and 3.5 s each with one thread.  One thread for
    this module's tests, the default after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROUNDS = 3
# f32, XLA against ATen: sums in other orders, a few ulps an op over two
# local steps of a few layers and three rounds.
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)  # the round step's new parameters
LOSS_RTOL = 1e-5
LEAF_SCALE_TOL = 1e-5  # a run's final parameters, relative to each leaf's largest entry

ARCHS = {  # reduced overrides: the reference's zoo_spec, a 4-block hybrid
    "smollm": ("smollm-360m", {"n_layers": 2, "d_model": 64, "d_ff": 128, "vocab": 128}),
    "ssm": ("zamba2-1.2b", {"n_layers": 4, "vocab": 128,
                            "block_pattern": ["mamba2", "mamba2", "mamba2", "shared_attn"]}),
}
# The moe and xlstm families, reduced (tests/test_torch_families_round.py):
# qwen3 dropless and with capacity drops, arctic with its dense residual
# (cohort_sequential, their configs' mode), xLSTM (client_parallel).
FAMILY_ARCHS = {
    "moe": ("qwen3-moe-235b-a22b", {"vocab": 128}),
    "moe_drops": ("qwen3-moe-235b-a22b", {"vocab": 128, "capacity_factor": 0.5}),
    "arctic": ("arctic-480b", {"vocab": 128}),
    "xlstm": ("xlstm-125m", {"vocab": 128}),
}


def spec_dict(arch="smollm", *, rounds=ROUNDS, sampler="kvib", **sections) -> dict:
    name, kwargs = {**ARCHS, **FAMILY_ARCHS}[arch]
    d = {
        "task": {"kind": "zoo", "name": name, "reduced": True, "kwargs": kwargs,
                 "dataset": "synthetic_tokens",
                 "dataset_kwargs": {"n_clients": 8, "seq_len": 16, "total_seqs": 256}},
        "sampler": {"name": sampler, "kwargs": {"horizon": rounds}},
        "federation": {"rounds": rounds, "budget": 2, "cohort": 3, "local_steps": 2,
                       "batch_size": 2, "local_lr": 0.05},
        "execution": {"seed": 5},
    }
    for section, over in sections.items():
        d[section] = {**d.get(section, {}), **over}
    return d


def ref_init(cfg, key):
    """The reference's ``init_params(cfg, key)``, jitted: eager, its many
    small ops take seconds; the draws are the same bits either way."""
    return jax.jit(lambda k: ref_tf.init_params(cfg, k))(key)


_STANDARD = {  # the latency family's standard variate, as the reference draws it
    "exponential": lambda key, shape: jax.random.exponential(key, shape, jnp.float32),
    "uniform": lambda key, shape: jax.random.uniform(key, shape, jnp.float32),
    "lognormal": lambda key, shape: jax.random.normal(key, shape, jnp.float32),
}


def zoo_replay(built, device="cpu") -> ReplaySource:
    """The reference zoo run's draws along its own key chain (module
    docstring), every client's (R, B) batch indices a round."""
    spec, rs = built.spec, built.round_spec
    n, k = built.dataset.n_clients, spec.federation.budget
    r, b = rs.local_steps, rs.local_batch
    sizes = jnp.asarray(built.dataset.sizes)
    key = jax.random.PRNGKey(spec.execution.seed)
    init = jax.tree_util.tree_map(np.asarray, ref_init(built.arch_config, key))

    def client_idx(k_data, cid):
        keys = jax.random.split(jax.random.fold_in(k_data, cid), r)
        return jax.vmap(lambda kr: jax.random.randint(kr, (b,), 0, sizes[cid]))(keys)

    tables = {name: [] for name in ("uniforms", "priorities", "batch_idx", "rsp_uniforms",
                                    "rsp_indices", "avail_uniforms", "latencies",
                                    "async_latencies")}
    for _ in range(spec.federation.rounds):
        key, k_draw, k_data = jax.random.split(key, 3)
        tables["uniforms"].append(jax.random.uniform(k_draw, (n,)))
        tables["rsp_uniforms"].append(jax.random.uniform(k_draw, (k,)))
        tables["rsp_indices"].append(jax.random.permutation(k_draw, n)[:k])
        tables["priorities"].append(jax.random.uniform(jax.random.fold_in(k_draw, 1), (n,)))
        tables["batch_idx"].append(jax.vmap(lambda c: client_idx(k_data, c))(jnp.arange(n)))
        if rs.faults is not None:
            std = _STANDARD[rs.faults.latency]
            tables["avail_uniforms"].append(
                jax.random.uniform(jax.random.fold_in(k_draw, 101), (n,)))
            tables["latencies"].append(std(jax.random.fold_in(k_draw, 102), (rs.cohort,)))
            tables["async_latencies"].append(std(jax.random.fold_in(k_draw, 103), ()))
    tables = {name: np.stack([np.asarray(x) for x in v]) for name, v in tables.items() if v}
    return ReplaySource(init, device=device, **tables)


def assert_leaves_close(got, want, tol=LEAF_SCALE_TOL):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().float().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


def run_both(d: dict, port_sections: dict | None = None):
    """``repro.api.run`` and the port's ``api.run`` on the CPU from the
    reference's recorded draws; ``port_sections`` changes only the port's
    spec (its sharded solve against the reference's unsharded one)."""
    ref_spec = ref_api.ExperimentSpec.from_dict(d)
    ref_built = ref_api.build(ref_spec)
    with pytest.MonkeyPatch.context() as mp:
        # The reference's host mesh is (1, 1); the installed jax builds it
        # with Explicit axes, which with_sharding_constraint refuses, so the
        # reference runs without the mesh (its constraints are the identity).
        mp.setattr(ref_runner, "_make_mesh", lambda spec: None)
        want = ref_api.run(ref_spec, built=ref_built)
    pd = dict(d)
    for section, over in (port_sections or {}).items():
        pd[section] = {**pd.get(section, {}), **over}
    replay = zoo_replay(ref_built)
    got = api.run(api.ExperimentSpec.from_dict(pd), "cpu", random_source=replay)
    return got, want, replay


def assert_runs_match(got, want, replay=None, step=None, elementwise=False):
    """Counts exact, losses within ``LOSS_RTOL``, parameters within
    ``LEAF_SCALE_TOL`` of each leaf's scale (``elementwise``: within
    ``PARAM_TOL``, ROADMAP's f32 rule, for the xLSTM runs, whose gradients
    agree within 4e-6 of each leaf's scale and drift past 1e-5 of it over
    three rounds of the recurrence).  With compression (``step``,
    the codes' relative spacing) a code flips where the two packages'
    scaled deltas straddle a rounding boundary, moving one element by one
    quantization step: the parameters are then held to one step of the
    run's movement from ``replay``'s initial weights, as
    ``tests/test_torch_compression.py`` holds the task stack's."""
    assert got.cohort_size == want.cohort_size
    assert got.cohort_dropped == want.cohort_dropped
    assert got.deadline_dropped == want.deadline_dropped
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=LOSS_RTOL)
    if step is None and elementwise:
        for g, w in zip(tree_leaves(got.final_params), jax.tree_util.tree_leaves(want.final_params)):
            np.testing.assert_allclose(g, np.asarray(w), **PARAM_TOL)
        return
    if step is None:
        assert_leaves_close(got.final_params, want.final_params)
        return
    init = tree_leaves(replay._init)
    final = [np.asarray(w) for w in jax.tree_util.tree_leaves(want.final_params)]
    movement = max(float(np.abs(f - i).max()) for f, i in zip(final, init))
    for a, b in zip(tree_leaves(got.final_params), final):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=step * movement)


# -- the round step ------------------------------------------------------------


@functools.cache
def _round_inputs(arch: str, c: int = 3, seed: int = 0):
    """The reference's weights in both packages, (C, R, B, S) tokens and
    targets, and cohort weights with slot 1 at zero; made once an arch for
    the round-step and round-mode checks, which read them only."""
    name, kwargs = {**ARCHS, **FAMILY_ARCHS}[arch]
    ref_cfg = ref_get_config(name).reduced(**kwargs)
    cfg = get_config(name).reduced(**kwargs)
    ref_params = ref_init(ref_cfg, jax.random.PRNGKey(seed))
    params = transformer.params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab, (c, 2, 2, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=-1)
    weights = np.array([1.7, 0.0, 2.4][:c] + [0.9] * max(0, c - 3), np.float32)
    return ref_cfg, ref_params, cfg, params, tokens, targets, weights


def check_round_step(arch, mode):
    """The round step against the reference's, jitted, on its weights."""
    ref_cfg, ref_params, cfg, params, tokens, targets, weights = _round_inputs(arch)
    ref_cfg = dataclasses.replace(ref_cfg, round_mode=mode)
    cfg = dataclasses.replace(cfg, round_mode=mode)
    spec = dict(cohort=3, local_steps=2, local_lr=0.05, server_lr=0.8, local_batch=2)
    want_p, want_n, want_l = jax.jit(ref_round.build_round_step(ref_cfg, ref_round.RoundSpec(**spec)))(
        ref_params, jnp.asarray(tokens), jnp.asarray(targets), jnp.asarray(weights))
    got_p, got_n, got_l = zoo_round.build_round_step(cfg, zoo_round.RoundSpec(**spec))(
        params, torch.from_numpy(tokens), torch.from_numpy(targets), torch.from_numpy(weights))
    for g, w in zip(tree_leaves(got_p), jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PARAM_TOL)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-5)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)


@pytest.mark.parametrize("mode", ["client_parallel", "cohort_sequential"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_round_step_matches_reference(arch, mode):
    check_round_step(arch, mode)


def check_round_modes(arch):
    """Both round modes agree; a w = 0 slot moves nothing."""
    _, _, cfg, params, tokens, targets, weights = _round_inputs(arch)
    spec = zoo_round.RoundSpec(cohort=3, local_steps=2, local_lr=0.05)
    args = (torch.from_numpy(tokens), torch.from_numpy(targets), torch.from_numpy(weights))
    outs = {
        mode: zoo_round.build_round_step(dataclasses.replace(cfg, round_mode=mode), spec)(params, *args)
        for mode in ("client_parallel", "cohort_sequential")
    }
    (pa, na, la), (pb, nb, lb) = outs.values()
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)
    np.testing.assert_allclose(na.numpy(), nb.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    # Other tokens in the w = 0 slot change its norm, not the parameters or the loss.
    tokens2 = tokens.copy()
    tokens2[1] = (tokens2[1] + 7) % cfg.vocab
    p2, n2, l2 = zoo_round.build_round_step(cfg, spec)(
        params, torch.from_numpy(tokens2), args[1], args[2])
    for a, b in zip(tree_leaves(pa), tree_leaves(p2)):
        assert torch.equal(a, b)
    assert float(l2) == float(la) and float(n2[1]) != float(na[1])
    # Every slot at w = 0: the parameters do not move.
    p0, _, l0 = zoo_round.build_round_step(cfg, spec)(params, *args[:2], torch.zeros(3))
    for a, b in zip(tree_leaves(p0), tree_leaves(params)):
        assert torch.equal(a, b)
    assert float(l0) == 0.0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_round_modes_agree_and_zero_weight_slot_is_inert(arch):
    check_round_modes(arch)


# -- api.run(kind="zoo") against repro.api.run ---------------------------------

RUN_CASES = {
    "plain": ("smollm", {}, None),
    "plain_ssm": ("ssm", {}, None),
    "markov_deadline_async": (
        "smollm", {"fault": {"availability": "markov", "deadline": 1.2, "async_buffer": 4}}, None),
    "int8_error_feedback": (
        "smollm", {"compression": {"delta_dtype": "int8", "error_feedback": True}}, None),
    "sampler_axis": ("smollm", {}, {"execution": {"sampler_axis": "data"}}),
    "vrb": ("smollm", {"sampler": "vrb"}, None),
}


def check_run(arch, sections, port_sections):
    """``api.run`` against ``repro.api.run`` on the reference's draws."""
    got, want, replay = run_both(spec_dict(arch, **sections), port_sections)
    step = 1.0 / 127.0 if "compression" in sections else None  # int8: absmax / 127
    assert_runs_match(got, want, replay, step, elementwise=arch == "xlstm")
    return want


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_matches_reference(case):
    arch, sections, port_sections = RUN_CASES[case]
    want = check_run(arch, sections, port_sections)
    if case == "markov_deadline_async":
        assert sum(want.deadline_dropped) > 0
    if case == "plain":
        assert sum(want.cohort_dropped) > 0  # C = 3 < |S| in a round


def test_run_resolves_cohort_and_accepts_built():
    """``cohort=None`` resolves to ``max(1, min(2K, N))``, and ``run`` takes
    the built experiment whose spec carries it."""
    d = spec_dict()
    d["federation"] = {k: v for k, v in d["federation"].items() if k != "cohort"}
    spec = api.ExperimentSpec.from_dict(d)
    built = api.build(spec, "cpu")
    assert built.spec.federation.cohort == 4 and built.round_spec.cohort == 4
    assert spec.federation.cohort is None
    ref_built = ref_api.build(ref_api.ExperimentSpec.from_dict(d))
    assert built.round_spec == dataclasses.replace(
        zoo_round.RoundSpec(**dataclasses.asdict(ref_built.round_spec)))
    hist = api.run(spec, "cpu", built=built)
    assert hist.cohort_size and max(hist.cohort_size) <= 4


# -- determinism and resume ------------------------------------------------------


def test_two_runs_are_bitwise_equal():
    """The embedding's gradient sums repeated tokens in a fixed order
    (``F.embedding``), so two vmap(grad) zoo runs of one spec give the same
    bits.  The indexing backward did not: at this size (vocab 16, 8 x 32
    tokens a local batch, many repeats) two runs with ``embed[tokens]``
    differed in every one of four tries."""
    d = spec_dict(rounds=2, federation={"batch_size": 8})
    d["task"]["kwargs"] = {**d["task"]["kwargs"], "vocab": 16}
    d["task"]["dataset_kwargs"] = {**d["task"]["dataset_kwargs"], "seq_len": 32}
    spec = api.ExperimentSpec.from_dict(d)
    a, b = api.run(spec, "cpu"), api.run(spec, "cpu")
    assert a.train_loss == b.train_loss
    for x, y in zip(tree_leaves(a.final_params), tree_leaves(b.final_params)):
        assert np.array_equal(x, y)


def test_preempt_resume_bitwise_and_changed_spec_refused(tmp_path):
    d = spec_dict(fault={"availability": "bernoulli", "availability_kwargs": {"q": 0.8},
                         "async_buffer": 2},
                  execution={"ckpt_every": 1})
    spec = api.ExperimentSpec.from_dict(d)
    full = api.run(spec, "cpu")
    fp = config_fingerprint(spec)
    built = api.build(spec, "cpu")
    segment, st0 = api.runner._zoo_segment_and_state(built)
    pre = run_segmented(st0, ROUNDS, segment, ckpt_every=1,
                        manager=CheckpointManager(str(tmp_path / "ck"), fingerprint=fp),
                        max_segments=1)
    assert pre.round == 1
    published = []
    resumed = api.run(spec, "cpu", ckpt_manager=CheckpointManager(str(tmp_path / "ck"),
                                                                  fingerprint=fp),
                      publish=lambda state, done: published.append((state.round, done)))
    assert published == [(2, 2), (3, 3)]  # each boundary after its commit
    assert resumed.train_loss == full.train_loss and resumed.cohort_size == full.cohort_size
    for x, y in zip(tree_leaves(resumed.final_params), tree_leaves(full.final_params)):
        assert np.array_equal(x, y)
    assert CheckpointManager(str(tmp_path / "ck")).latest() == ROUNDS
    changed = api.ExperimentSpec.from_dict(spec_dict(execution={"ckpt_every": 1, "seed": 6}))
    with pytest.raises(ValueError, match="fingerprint"):
        CheckpointManager(str(tmp_path / "ck"), fingerprint=config_fingerprint(changed)).restore(
            api.restore_template(changed, device="cpu"))


def test_restore_template_is_the_round_zero_state():
    spec = api.ExperimentSpec.from_dict(
        spec_dict(compression={"delta_dtype": "int8", "error_feedback": True}))
    st = api.restore_template(spec, device="cpu")
    d_dim = sum(x.numel() for x in tree_leaves(st.params))
    assert st.round == 0 and st.opt_state == ()
    assert sorted(st.metrics) == ["cohort_size", "dropped", "loss"]
    assert all(b.shape[0] == ROUNDS for b in st.metrics.values())
    assert st.compression["resid"].shape == (d_dim,) and st.faults == ()
    assert len(tree_flatten(st)) > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3-405b", "gemma2-27b"])
def test_every_served_dense_arch_runs(arch):
    """Every dense config the port's registry serves runs the zoo round
    (reduced, f32, one round), in its config's round mode."""
    spec = api.ExperimentSpec.from_dict({**spec_dict(rounds=1), "task": {
        **spec_dict()["task"], "name": arch, "kwargs": {"vocab": 128, "n_layers": 2}}})
    built = api.build(spec, "cpu")
    hist = api.run(spec, "cpu", built=built)
    assert built.arch_config.round_mode == get_config(arch).round_mode
    assert len(hist.train_loss) == 1 and np.isfinite(hist.train_loss[0])
    assert all(np.isfinite(x).all() for x in tree_leaves(hist.final_params))


# -- spec and refusals -------------------------------------------------------------


def test_round_spec_and_its_errors():
    spec = api.ExperimentSpec.from_dict(spec_dict(
        federation={"server_opt_kwargs": {"lr": 0.7}},
        fault={"deadline": 2.0}, compression={"delta_dtype": "fp8"}))
    ref = ref_api.ExperimentSpec.from_dict(spec.to_dict()).round_spec()
    assert dataclasses.asdict(spec.round_spec()) == dataclasses.asdict(ref)
    assert spec.round_spec().server_lr == 0.7
    d = spec_dict()
    d["federation"].pop("cohort")
    for bad, match in ((d, "cohort is None"),
                       (spec_dict(federation={"server_opt": "fedadam"}), "server_opt")):
        with pytest.raises(ValueError, match=match):
            api.ExperimentSpec.from_dict(bad).round_spec()
        with pytest.raises(ValueError, match=match):
            ref_api.ExperimentSpec.from_dict(bad).round_spec()


def test_refusals():
    with pytest.raises(NotImplementedError, match="item 6"):
        api.build(api.ExperimentSpec.from_dict(spec_dict(execution={"mesh_shape": [2, 1]})), "cpu")
    one = api.build(api.ExperimentSpec.from_dict(spec_dict(execution={"mesh_shape": [1, 1]})), "cpu")
    assert one.kind == "zoo"
    spec = api.ExperimentSpec.from_dict(spec_dict())
    x = np.zeros((2, 16), np.int32)
    with pytest.raises(ValueError, match="eval_data"):
        api.run(spec, "cpu", eval_data=(x, x))
    task = api.ExperimentSpec.from_dict({"task": {"name": "logreg"}})
    with pytest.raises(ValueError, match="publish"):
        api.run(task, "cpu", publish=lambda s, d: None)
    other = api.ExperimentSpec.from_dict(spec_dict(sampler="vrb"))
    with pytest.raises(ValueError, match="different spec"):
        api.run(other, "cpu", built=api.build(spec, "cpu"))
    # The frontend archs build, as the reference's do; their run fails in
    # round 0, where the reference's does (api.run passes no aux_embeds): here
    # with a ValueError naming them, there with an AttributeError on None.
    for arch in ("llama-3.2-vision-11b", "whisper-small"):
        frontend = api.ExperimentSpec.from_dict({**spec_dict(rounds=1), "task": {
            **spec_dict()["task"], "name": arch, "kwargs": {"vocab": 128}}})
        assert api.build(frontend, "cpu").arch_config.frontend
        with pytest.raises(ValueError, match="needs its frontend embeddings"):
            api.run(frontend, "cpu")
    # arctic-480b at full width does not fit one card's round (one layer
    # alone holds 14.07e9 parameters).
    arctic = api.ExperimentSpec.from_dict({**spec_dict(), "task": {
        **spec_dict()["task"], "name": "arctic-480b", "reduced": False, "kwargs": {}}})
    with pytest.raises(NotImplementedError, match="item 6, 'Multi-rank placement'"):
        api.build(arctic, "cpu")
    with pytest.raises(ValueError, match="unknown zoo arch"):
        api.build(api.ExperimentSpec.from_dict(
            {**spec_dict(), "task": {**spec_dict()["task"], "name": "nope"}}), "cpu")
    # Compression needs the client_parallel mode; gemma2's is cohort_sequential.
    gemma = api.ExperimentSpec.from_dict({
        **spec_dict(compression={"delta_dtype": "int8"}),
        "task": {**spec_dict()["task"], "name": "gemma2-27b", "kwargs": {"vocab": 128}}})
    with pytest.raises(ValueError, match="client_parallel"):
        api.run(gemma, "cpu")
    built = api.build(spec, "cpu")
    for section in ({"faults": api.FaultSpec(deadline=1.0)},
                    {"compression": api.CompressionSpec(delta_dtype="int8")}):
        with pytest.raises(ValueError, match="segment-shaped"):
            zoo_round.build_fed_scan(built.arch_config, dataclasses.replace(built.round_spec, **section),
                                     built.sampler, built.dataset, source=ReplaySource())


def test_build_fed_scan_is_one_segment():
    spec = api.ExperimentSpec.from_dict(spec_dict(rounds=2))
    built = api.build(spec, "cpu")
    src = PhiloxSource(5, "cpu")
    params = src.init_params(zoo_round.ZooModel(built.arch_config))
    run = zoo_round.build_fed_scan(built.arch_config, built.round_spec, built.sampler,
                                   built.dataset, source=src)
    p, _, metrics = run(params, built.sampler.init("cpu"), 2)
    hist = api.run(spec, "cpu")
    assert [float(x) for x in metrics["loss"]] == hist.train_loss
    for x, y in zip(tree_leaves(p), tree_leaves(hist.final_params)):
        assert np.array_equal(x.numpy(), y)


def test_host_gather_cohort_batches_matches_device_gather():
    spec = api.ExperimentSpec.from_dict(spec_dict())
    ds = api.build(spec, "cpu").dataset
    n = ds.n_clients
    mask = torch.zeros(n, dtype=torch.bool)
    mask[[1, 4]] = True
    sel = cohort.select_cohort(mask, torch.ones(n), 3, torch.rand(n, generator=torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    idx = torch.minimum((torch.rand(n, 2, 2, generator=gen) * ds.sizes.reshape(-1, 1, 1)).long(),
                        ds.sizes.reshape(-1, 1, 1) - 1)
    feats, labs = cohort.host_gather_cohort_batches(ds, sel, idx[sel.ids].numpy(), 2, 2)
    want_f, want_l = ds.gather(sel.ids, idx[sel.ids])
    keep = sel.valid.reshape(-1, 1, 1, 1)
    assert feats.shape == (3, 2, 2, 16) and labs.shape == (3, 2, 2, 16)
    assert torch.equal(feats, torch.where(keep, want_f, 0))
    assert torch.equal(labs, torch.where(keep, want_l, 0))
    assert int(sel.valid.sum()) == 2 and not bool(feats[~sel.valid].any())


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def check_run_on_card(arch, cuda):
    """The reduced f32 zoo run on the card (kernels 6-8 forward) follows the
    CPU's from one recorded source: the CPU run's draws, replayed."""
    spec = api.ExperimentSpec.from_dict(spec_dict(arch))
    src = PhiloxSource(0, "cpu")
    built = api.build(spec, "cpu")
    n, rs = built.dataset.n_clients, built.round_spec
    rounds = spec.federation.rounds
    init = transformer.init_params(built.arch_config, torch.Generator().manual_seed(3), "cpu")
    tables = dict(
        uniforms=torch.stack([src.isp_uniforms(t, n) for t in range(rounds)]).numpy(),
        priorities=torch.stack([src.cohort_priorities(t, n) for t in range(rounds)]).numpy(),
        batch_idx=torch.stack([src.batch_indices(t, built.dataset.sizes, rs.local_steps,
                                                 rs.local_batch) for t in range(rounds)]).numpy(),
    )
    ref_tree = params_to_numpy(init)
    cpu = api.run(spec, "cpu", random_source=ReplaySource(ref_tree, **tables))
    gpu = api.run(spec, cuda, random_source=ReplaySource(ref_tree, device=cuda, **tables))
    assert gpu.cohort_size == cpu.cohort_size and gpu.cohort_dropped == cpu.cohort_dropped
    np.testing.assert_allclose(gpu.train_loss, cpu.train_loss, rtol=1e-5)
    for g, c in zip(tree_leaves(gpu.final_params), tree_leaves(cpu.final_params)):
        assert float(np.abs(g - c).max()) <= 1e-4 * max(float(np.abs(c).max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(ARCHS))
def test_zoo_run_on_card_matches_cpu(arch, cuda):
    check_run_on_card(arch, cuda)
