"""The port's fault layer against the JAX reference, on the CPU.

Each function of ``repro_torch.core.stragglers`` (and
``fed.cohort.mask_selection``) is held against ``repro.core.stragglers`` on
the same numpy inputs, with the reference's own draws replayed: the uniforms,
exponentials and normals its keys give are handed to the port.  Then
``repro_torch.api.run`` with an enabled fault section follows
``repro.api.run`` round by round on the reference's replayed draws
(``test_torch_slice.jax_replay``, which records the fault layer's
``fold_in(k_sample, 101/102/103)`` draws).

Tolerances: masks, counts, ring bookkeeping and quantized codes are exact;
float outputs of one elementwise step are within 1e-6 relative (``exp`` and
``pow`` may differ by an ulp between the two libraries); the runs keep the
slice's bounds (``test_torch_slice``, ``test_torch_compression``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import stragglers as ref_st  # noqa: E402
from repro.core.samplers import SampleResult as RefDraw  # noqa: E402
from repro.fed import cohort as ref_cohort  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import stragglers as st  # noqa: E402
from repro_torch.core.samplers import SampleResult  # noqa: E402
from repro_torch.fed import cohort  # noqa: E402
from repro_torch.fed.tasks import params_to_numpy  # noqa: E402
from test_torch_compression import STEP, _leaves  # noqa: E402
from test_torch_slice import _STANDARD, METRIC_TOL, PARAM_TOL, _spec, jax_replay  # noqa: E402

N = 11
ELEMENTWISE = dict(rtol=1e-6, atol=0.0)


def _key(i):
    return jax.random.PRNGKey(1000 + i)


def _fault(**kw):
    return ref_api.FaultSpec(**kw)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- availability -----------------------------------------------------------


@pytest.mark.parametrize(
    "fault",
    [
        _fault(availability="bernoulli", availability_kwargs={"q": 0.7}),
        _fault(availability="bernoulli", availability_kwargs={"q": tuple(np.linspace(0.0, 1.0, N))}),
        _fault(availability="markov", availability_kwargs={"p_on": 0.3, "p_off": 0.2}),
        _fault(availability="diurnal", availability_kwargs={"period": 5.0, "duty": 0.4}),
    ],
    ids=["bernoulli", "bernoulli_per_client", "markov", "diurnal"],
)
def test_availability_step_matches_reference(fault):
    """Mask, q and chain over several rounds, the chain carried, on the
    reference's own uniforms."""
    chain_r = ref_st.availability_init(fault, N)
    chain_p = st.availability_init(fault, N, "cpu")
    for t in range(7):
        key = _key(t)
        mask_r, q_r, chain_r = ref_st.availability_step(fault, chain_r, jnp.int32(t), key, N)
        u = None if fault.availability == "diurnal" else _t(jax.random.uniform(key, (N,)))
        mask_p, q_p, chain_p = st.availability_step(fault, chain_p, t, u, N, "cpu")
        np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_r))
        np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
        assert q_p.dtype == torch.float32 and mask_p.dtype == torch.bool
        if chain_r is None:
            assert chain_p is None
        else:
            assert chain_p.dtype == torch.bool
            np.testing.assert_array_equal(chain_p.numpy(), np.asarray(chain_r))


def _draw(seed):
    rng = np.random.default_rng(seed)
    marg = rng.uniform(0.05, 1.0, N).astype(np.float32)
    mask = rng.uniform(size=N) < marg
    dp = (marg / marg.sum()).astype(np.float32)
    ref = RefDraw(jnp.asarray(mask), jnp.asarray(mask.astype(np.int32)), jnp.asarray(marg), jnp.asarray(dp))
    port = SampleResult(_t(mask), _t(mask.astype(np.int32)), _t(marg), _t(dp))
    return ref, port, rng


def test_available_draw_composition_matches_reference():
    """Composed draw (mask, counts, q*p) and the two-step weights agree;
    q == 0 clients leave the composed mask."""
    ref, port, rng = _draw(0)
    avail = rng.uniform(size=N) < 0.8
    q = rng.uniform(0.2, 1.0, N).astype(np.float32)
    q[3] = 0.0
    lam = rng.uniform(0.01, 0.2, N).astype(np.float32)
    for with_q in (True, False):
        got = st.available_draw(port, _t(avail), _t(q) if with_q else None)
        want = ref_st.available_draw(ref, jnp.asarray(avail), jnp.asarray(q) if with_q else None)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(st.available_draw(port, _t(np.ones(N, bool)), _t(q)).mask[3])
    # The two-step form: the draw masked without q, then the 1/q weights.
    masked_p = st.available_draw(port, _t(avail & (q > 0)))
    masked_r = ref_st.available_draw(ref, jnp.asarray(avail & (q > 0)))
    got = st.availability_weights(masked_p, _t(lam), _t(q), "isp", 3)
    want = ref_st.availability_weights(masked_r, jnp.asarray(lam), jnp.asarray(q), "isp", 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ELEMENTWISE)


def test_zero_availability_raises_like_reference():
    ref, port, _ = _draw(1)
    q = np.full(N, 0.5, np.float32)
    drawn = int(np.nonzero(np.asarray(ref.mask))[0][0])
    q[drawn] = 0.0
    lam = np.full(N, 1.0 / N, np.float32)
    with pytest.raises(ref_st.ZeroAvailabilityError, match=f"clients \\[{drawn}"):
        ref_st.availability_weights(ref, jnp.asarray(lam), jnp.asarray(q), "isp", 3)
    with pytest.raises(st.ZeroAvailabilityError, match=f"clients \\[{drawn}"):
        st.availability_weights(port, _t(lam), _t(q), "isp", 3)


# -- deadline stragglers ------------------------------------------------------

LATENCIES = [
    ("exponential", {"scale": 0.8}),
    ("uniform", {"lo": 0.25, "hi": 2.5}),
    ("lognormal", {"mu": -0.3, "sigma": 0.7}),
]


@pytest.mark.parametrize("dist,kw", LATENCIES, ids=[d for d, _ in LATENCIES])
def test_deadline_survival_and_latency_draw_match_reference(dist, kw):
    fault = _fault(deadline=1.1, latency=dist, latency_kwargs=kw)
    assert st.deadline_survival(fault) == ref_st.deadline_survival(fault)
    for shape in [(N,), (4,), ()]:
        key = _key(len(shape))
        want = np.asarray(ref_st.latency_draw(fault, shape, key))
        got = st.latency_draw(fault, _t(_STANDARD[dist](key, shape)))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), want, **ELEMENTWISE)


@pytest.mark.parametrize(
    "dist,kw,deadline",
    [("exponential", {"scale": 1.0}, 1e-14), ("uniform", {"lo": 2.0, "hi": 3.0}, 1.0),
     ("lognormal", {}, 1e-30)],
    ids=["exponential", "uniform", "lognormal"],
)
def test_unsatisfiable_deadline_raises(dist, kw, deadline):
    """Both packages refuse a deadline no client can meet, in the function
    and when the spec is built."""
    fault = types.SimpleNamespace(deadline=deadline, latency=dist, latency_kwargs=kw)
    for fn in (ref_st.deadline_survival, st.deadline_survival):
        with pytest.raises(ValueError, match="survival probability"):
            fn(fault)
    for mod in (ref_api, api):
        with pytest.raises(ValueError, match="survival probability"):
            mod.FaultSpec(deadline=deadline, latency=dist, latency_kwargs=kw)


def test_mask_selection_matches_reference():
    rng = np.random.default_rng(3)
    c = 6
    fields = dict(
        ids=rng.permutation(9)[:c].astype(np.int64),
        weights=np.where(np.arange(c) < 4, rng.uniform(0.5, 2.0, c), 0.0).astype(np.float32),
        valid=np.arange(c) < 4,
        n_included=np.int32(5),
        n_dropped=np.int32(1),
    )
    keep = np.array([True, False, True, False, True, True])
    want = ref_cohort.mask_selection(
        ref_cohort.CohortSelection(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(keep), 1.0 / 0.55,
    )
    got = cohort.mask_selection(
        cohort.CohortSelection(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        _t(keep), 1.0 / 0.55,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert int(got.n_dropped) == int(want.n_dropped) == 3
    assert int(got.n_included) == int(want.n_included)


# -- buffered async -----------------------------------------------------------


@pytest.mark.parametrize("comp", [None, "int8", "fp8"], ids=["f32", "int8", "fp8"])
def test_async_ring_and_flush_match_reference(comp):
    """Seven rounds through a B=3 ring (delays 0..2 from the reference's own
    exponentials), then the end-of-horizon flush."""
    from test_torch_compression import _Comp, _codes

    fault = _fault(async_buffer=3, staleness_discount=0.6, round_time=0.5)
    d = 300
    compression = None if comp is None else _Comp(comp, scale_block=64)
    buf_r = ref_st.fault_state_init(fault, N, d, compression)["buf"]
    buf_p = st.fault_state_init(fault, N, d, compression, "cpu")["buf"]
    rng = np.random.default_rng(4)
    arrived_total = 0
    for t in range(7):
        u = rng.standard_normal(d).astype(np.float32)
        key = _key(t)
        buf_r, vec_r, n_r = ref_st.async_step(fault, buf_r, jnp.asarray(u), jnp.int32(t), key, compression)
        buf_p, vec_p, n_p = st.async_step(
            fault, buf_p, _t(u), t, _t(_STANDARD["exponential"](key, ())), compression
        )
        assert int(n_p) == int(n_r)
        arrived_total += int(n_p)
        for k in ("dispatch", "arrival", "valid"):
            np.testing.assert_array_equal(buf_p[k].numpy(), np.asarray(buf_r[k]), err_msg=k)
        if comp is None:
            np.testing.assert_array_equal(buf_p["delta"].numpy(), np.asarray(buf_r["delta"]))
        else:
            np.testing.assert_array_equal(_codes(buf_p["delta"]), _codes(buf_r["delta"]))
            np.testing.assert_array_equal(buf_p["scale"].numpy(), np.asarray(buf_r["scale"]))
        assert vec_p.shape == (d,)
        np.testing.assert_allclose(vec_p.numpy(), np.asarray(vec_r), rtol=1e-6, atol=1e-6)
    assert 0 < arrived_total < 7 and bool(buf_p["valid"].any())
    want = ref_st.flush_pending(buf_r, 7, 0.6)
    got = st.flush_pending(buf_p, 7, 0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_tree_vec_round_trip_matches_reference():
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"z": rng.standard_normal(2).astype(np.float32), "a": np.float32(rng.standard_normal(1))}}
    tree["b"]["a"] = rng.standard_normal(()).astype(np.float32)
    to_t = {"w": _t(tree["w"]), "b": {"z": _t(tree["b"]["z"]), "a": _t(tree["b"]["a"])}}
    vec = st.tree_to_vec(to_t)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(ref_st.tree_to_vec(tree)))
    back = st.vec_to_tree(vec * 2, to_t)
    for a, b in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), 2 * b)
    assert st.flat_dim(to_t) == ref_st.flat_dim(tree) == 15


# -- the faulted round, end to end --------------------------------------------

FAULTS = {
    "markov_deadline_async": (
        {"availability": "markov", "availability_kwargs": {"p_on": 0.6, "p_off": 0.3},
         "deadline": 1.2, "latency": "exponential", "async_buffer": 4},
        None,
    ),
    "bernoulli_int8_ef_async": (
        {"availability": "bernoulli", "availability_kwargs": {"q": 0.7}, "async_buffer": 4,
         "round_time": 0.5},
        {"delta_dtype": "int8"},
    ),
    "diurnal_uniform_deadline": (
        {"availability": "diurnal", "availability_kwargs": {"period": 3.0, "duty": 0.7},
         "deadline": 0.8, "latency": "uniform", "latency_kwargs": {"lo": 0.2, "hi": 1.4}},
        None,
    ),
    "lognormal_deadline_fp8_async": (
        {"deadline": 1.0, "latency": "lognormal", "latency_kwargs": {"sigma": 0.8},
         "async_buffer": 2},
        {"delta_dtype": "fp8", "error_feedback": False},
    ),
}
RUNS = [(task, oracle, f) for task in ("logreg", "tiny_lm") for oracle in (True, False)
        for f in ("markov_deadline_async", "bernoulli_int8_ef_async")]
RUNS += [("logreg", oracle, f) for oracle in (True, False)
         for f in ("diurnal_uniform_deadline", "lognormal_deadline_fp8_async")]


def _faulted(ref_spec, name):
    fault, comp = FAULTS[name]
    d = ref_spec.to_dict()
    d["fault"] = fault
    if comp is not None:
        d["compression"] = comp
    d["federation"] = {**d["federation"], "rounds": 5}
    d["sampler"] = {**d["sampler"], "kwargs": {"horizon": 5}}
    return ref_api.ExperimentSpec.from_dict(d)


@pytest.mark.parametrize(
    "task,oracle,name", RUNS,
    ids=[f"{t}-{'oracle' if o else 'deployable'}-{f}" for t, o, f in RUNS],
)
def test_faulted_run_matches_reference(task, oracle, name):
    ref_spec = _faulted(_spec(task, oracle), name)
    ref_built = ref_api.build(ref_spec)
    want = ref_api.run(ref_spec, built=ref_built)
    replay = jax_replay(ref_built)
    got = api.run(api.ExperimentSpec.from_json(ref_spec.to_json()), device="cpu", random_source=replay)

    assert len(got.train_loss) == 5
    assert got.cohort_size == want.cohort_size
    assert got.cohort_dropped == want.cohort_dropped
    assert got.deadline_dropped == want.deadline_dropped
    if ref_spec.fault.deadline is not None:
        assert sum(got.deadline_dropped) > 0
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    if oracle:
        np.testing.assert_allclose(got.estimator_sq_error, want.estimator_sq_error, **METRIC_TOL)
        np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
    comp = FAULTS[name][1]
    if comp is None:
        for a, b in zip(_leaves(got.final_params), _leaves(want.final_params)):
            np.testing.assert_allclose(a, b, **PARAM_TOL)
        return
    init = _leaves(params_to_numpy(replay.init_params(None)))
    final = _leaves(want.final_params)
    movement = max(float(np.abs(f - i).max()) for f, i in zip(final, init))
    for a, b in zip(_leaves(got.final_params), final):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=STEP[comp["delta_dtype"]] * movement)


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "deployable"])
def test_compiled_and_eager_agree_faulted(oracle):
    """compiled=True and compiled=False give bitwise-equal faulted runs, with
    the fault state (chain, ring) and the residual in the carry."""
    spec = api.ExperimentSpec.from_json(
        _faulted(_spec("logreg", oracle), "markov_deadline_async").to_json()
    )
    d = spec.to_dict()
    d["compression"] = {"delta_dtype": "int8"}
    spec = api.ExperimentSpec.from_dict(d)
    eager = api.ExperimentSpec.from_dict({**d, "execution": {**d["execution"], "compiled": False}})
    a = api.run(spec, device="cpu")
    b = api.run(eager, device="cpu")
    assert a.train_loss == b.train_loss and a.cohort_size == b.cohort_size
    assert a.deadline_dropped == b.deadline_dropped and len(a.deadline_dropped) == 5
    for x, y in zip(_leaves(a.final_params), _leaves(b.final_params)):
        np.testing.assert_array_equal(x, y)


def test_faulted_run_with_no_rounds():
    d = _faulted(_spec("logreg", False), "markov_deadline_async").to_dict()
    d["federation"] = {**d["federation"], "rounds": 0}
    hist = api.run(api.ExperimentSpec.from_dict(d), device="cpu")
    assert hist.train_loss == [] and hist.deadline_dropped == []
