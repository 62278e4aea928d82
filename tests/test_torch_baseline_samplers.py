"""The paper's baseline samplers and the RSP procedure, ported, against the
JAX reference on the CPU.

Each sampler runs five rounds of probabilities -> draw -> update on both
sides, the port fed the inputs the reference draws from its keys: for ISP
the (N,) uniforms of ``jax.random.uniform(key, (N,))``, for RSP with
replacement the (K,) uniforms ``jax.random.choice(key, n, (K,), p=p)``
searches at, for RSP without replacement the first K of
``jax.random.permutation(key, n)``.  Then ``repro_torch.api.run`` follows
``repro.api.run`` on replayed draws (``test_torch_slice.jax_replay``).  The
``cuda`` case holds each sampler's round on the card to the same round on
the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import estimator as ref_estimator  # noqa: E402
from repro.core import samplers as ref_samplers  # noqa: E402
from repro.fed import cohort as ref_cohort  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import estimator, samplers  # noqa: E402
from repro_torch.fed import cohort  # noqa: E402
from repro_torch.rng import PhiloxSource  # noqa: E402
from test_torch_slice import METRIC_TOL, PARAM_TOL, _spec, jax_replay  # noqa: E402

# Probabilities and state: f32 sums in another order (XLA vs ATen).
TOL = dict(rtol=1e-5, atol=1e-4)
N, K = 24, 4
CLUSTERS = tuple(i % 5 for i in range(N))

NEW_SAMPLERS = {  # the seven samplers this port adds, with the kwargs tested
    "uniform_rsp": {},
    "vrb": {"horizon": 5},
    "mabs": {},
    "avare": {},
    "optimal_isp": {},
    "osmd": {},
    "clustered_kvib": {"horizon": 5, "cluster_ids": CLUSTERS},
}
MORE_KWARGS = {  # further settings of the same samplers
    "vrb_gamma": ("vrb", {"gamma": 0.5, "theta": 0.2}),
    "mabs_eta": ("mabs", {"eta": 0.9, "theta": 0.3}),
    "osmd_lr": ("osmd", {"lr": 1.5, "p_min_frac": 0.5}),
    "clustered_kvib_alone": ("clustered_kvib", {"horizon": 5}),
    "clustered_kvib_gamma": ("clustered_kvib", {"gamma": 2.0, "cluster_ids": (0, 2) * (N // 2)}),
}
CASES = {**{k: (k, v) for k, v in NEW_SAMPLERS.items()}, **MORE_KWARGS}
# The reference's nine registry names (test_torch_solver_samplers checks
# that both registries hold exactly these).
NAMES = sorted([*NEW_SAMPLERS, "kvib", "uniform_isp"])


def _port_input(ref, p_r, key, n: int, budget: int) -> torch.Tensor:
    """The port's draw input for the reference's ``sample_from(p_r, key)``,
    with a check that no draw hinges on a rounding of the reference's
    arithmetic against the port's."""
    if ref.procedure == "isp":
        u = np.array(jax.random.uniform(key, (n,)))
        assert np.min(np.abs(u - np.asarray(p_r))) > 1e-5
        return torch.from_numpy(u)
    if ref.procedure == "rsp_wr":
        u = np.array(jax.random.uniform(key, (budget,)))
        p = np.asarray(p_r, np.float64)
        cum = np.cumsum(p / p.sum())
        r = cum[-1] * (1.0 - u)
        assert np.min(np.abs(r[:, None] - cum[None, :])) > 1e-6
        return torch.from_numpy(u)
    return torch.from_numpy(np.asarray(jax.random.permutation(key, n))[:budget])


def _assert_draws_equal(d_p, d_r):
    np.testing.assert_array_equal(d_p.mask.numpy(), np.asarray(d_r.mask))
    np.testing.assert_array_equal(d_p.counts.numpy(), np.asarray(d_r.counts))
    assert d_p.counts.dtype == torch.int32
    np.testing.assert_allclose(d_p.marginals.numpy(), np.asarray(d_r.marginals), **TOL)
    np.testing.assert_allclose(d_p.draw_probs.numpy(), np.asarray(d_r.draw_probs), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampler_trajectory_matches(case):
    """Five rounds of probabilities -> draw -> update, the port fed the
    draws' inputs the reference takes from its keys, and the same feedback:
    probabilities and state within f32 tolerance, masks and counts exact."""
    name, kw = CASES[case]
    ref = ref_samplers.make_sampler(name, N, K, **kw)
    pt = samplers.make_sampler(name, N, K, **kw)
    assert pt.procedure == ref.procedure
    st_r, st_p = ref.init(), pt.init("cpu")
    rng = np.random.default_rng(sum(map(ord, case)))
    for t in range(5):
        key = jax.random.PRNGKey(200 + t)
        p_r = ref.probabilities(st_r)
        p_p = pt.probabilities(st_p)
        np.testing.assert_allclose(p_p.numpy(), np.asarray(p_r), **TOL)
        d_r = ref.sample_from(p_r, key)
        d_p = pt.sample_from(p_p, _port_input(ref, p_r, key, N, K))
        _assert_draws_equal(d_p, d_r)
        fb = (rng.lognormal(0, 1, N) * np.asarray(d_r.mask)).astype(np.float32)
        st_r = ref.update(st_r, d_r, jnp.asarray(fb))
        st_p = pt.update(st_p, d_p, torch.from_numpy(fb))
        for f in ("stats", "aux"):
            want = np.asarray(getattr(st_r, f))
            got = getattr(st_p, f).numpy()
            np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], **TOL, err_msg=f)
        assert int(st_p.t) == int(st_r.t) == t + 1
    samplers.assert_serializable_state(st_p)


@pytest.mark.parametrize("p_kind", ["uniform", "lognormal", "zeros", "dominant", "zero_head"])
def test_rsp_wr_draw_matches_jax_choice(p_kind):
    """``_rsp_wr_draw`` on the uniforms ``jax.random.choice(..., p=p)``
    searches at gives the reference's counts, mask and marginals, clients
    with p = 0 never drawn."""
    n, budget = 50, 10
    rng = np.random.default_rng(sum(map(ord, p_kind)))
    p = {
        "uniform": np.ones(n),
        "lognormal": rng.lognormal(0, 1.5, n),
        "zeros": np.where(np.arange(n) % 3 == 0, 0.0, rng.uniform(0.1, 1.0, n)),
        "dominant": np.r_[40.0, rng.uniform(0.01, 0.1, n - 1)],
        "zero_head": np.r_[np.zeros(5), rng.uniform(0.1, 1.0, n - 5)],
    }[p_kind].astype(np.float32)
    p /= p.sum()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = ref_samplers._rsp_wr_draw(key, jnp.asarray(p), budget)
        idx = np.asarray(jax.random.choice(key, n, (budget,), p=jnp.asarray(p)))
        np.testing.assert_array_equal(np.bincount(idx, minlength=n), np.asarray(want.counts))
        u = np.array(jax.random.uniform(key, (budget,)))
        got = samplers._rsp_wr_draw(torch.from_numpy(u), torch.from_numpy(p), budget)
        _assert_draws_equal(got, want)
        assert int(got.counts.sum()) == budget
        assert not bool((got.mask & (torch.from_numpy(p) == 0)).any())


@pytest.mark.parametrize("n,budget", [(10, 3), (24, 4), (100, 10)])
def test_rsp_wor_draw_matches_permutation(n, budget):
    """``_rsp_wor_uniform_draw`` on the first K of
    ``jax.random.permutation(key, n)`` is the reference's draw: K distinct
    clients, marginals K/N."""
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = ref_samplers._rsp_wor_uniform_draw(key, n, budget)
        idx = np.asarray(jax.random.permutation(key, n))[:budget]
        got = samplers._rsp_wor_uniform_draw(torch.from_numpy(idx), n, budget)
        _assert_draws_equal(got, want)
        assert int(got.counts.max()) == 1 and int(got.size) == budget


@pytest.mark.parametrize("procedure", ["rsp_wr", "rsp_wor", "isp"])
def test_client_weights_branches(procedure):
    """Both RSP branches of ``client_weights`` (and ISP's) on the
    reference's own draws: counts * lam / (K q) and lam / p."""
    n, budget = 30, 6
    rng = np.random.default_rng(3)
    lam = rng.dirichlet(np.ones(n)).astype(np.float32)
    p = rng.uniform(0.05, 1.0, n).astype(np.float32)
    key = jax.random.PRNGKey(7)
    if procedure == "rsp_wr":
        d_r = ref_samplers._rsp_wr_draw(key, jnp.asarray(p / p.sum()), budget)
    elif procedure == "rsp_wor":
        d_r = ref_samplers._rsp_wor_uniform_draw(key, n, budget)
    else:
        d_r = ref_samplers._isp_draw(key, jnp.asarray(p * budget / p.sum()))
    d_p = samplers.SampleResult(*(torch.from_numpy(np.asarray(f)) for f in d_r))
    want = np.asarray(ref_estimator.client_weights(d_r, jnp.asarray(lam), procedure, budget))
    got = estimator.client_weights(d_p, torch.from_numpy(lam), procedure, budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)
    assert bool(((got > 0) == d_p.mask).all())
    with pytest.raises(ValueError, match="unknown procedure"):
        estimator.client_weights(d_p, torch.from_numpy(lam), "nope", budget)


def _states(kind: str):
    """(reference state, port state) of one serializable-state case."""
    ok_r = ref_samplers.SamplerState(
        stats=jnp.zeros(3), aux=jnp.zeros(3), t=jnp.zeros((), jnp.int32)
    )
    ok_p = samplers.SamplerState(
        stats=torch.zeros(3), aux=torch.zeros(3), t=torch.zeros((), dtype=torch.int32)
    )
    if kind == "ok":
        return ok_r, ok_p
    if kind == "python_scalar":
        return {"stats": ok_r.stats, "t": 0}, {"stats": ok_p.stats, "t": 0}
    if kind == "float64":
        return ({"stats": np.zeros(3, np.float64)},
                {"stats": torch.zeros(3, dtype=torch.float64)})
    if kind == "complex128":
        return ({"stats": np.zeros(3, np.complex128)},
                {"stats": torch.zeros(3, dtype=torch.complex128)})
    if kind == "int_and_bool":
        return ({"c": np.zeros(3, np.int32), "m": np.zeros(3, bool)},
                {"c": torch.zeros(3, dtype=torch.int32), "m": torch.zeros(3, dtype=torch.bool)})
    if kind == "empty":
        return {}, {}
    raise KeyError(kind)


@pytest.mark.parametrize(
    "kind,error",
    [("ok", None), ("int_and_bool", None), ("python_scalar", TypeError),
     ("float64", TypeError), ("complex128", TypeError), ("empty", ValueError)],
)
def test_assert_serializable_state_like_reference(kind, error):
    st_r, st_p = _states(kind)
    for check, st in ((ref_samplers.assert_serializable_state, st_r),
                      (samplers.assert_serializable_state, st_p)):
        if error is None:
            check(st)
        else:
            with pytest.raises(error):
                check(st)


@pytest.mark.parametrize("name", NAMES)
def test_every_initial_state_is_serializable(name):
    kw = {"cluster_ids": CLUSTERS} if name == "clustered_kvib" else {}
    samplers.assert_serializable_state(samplers.make_sampler(name, N, K, **kw).init("cpu"))


def test_philox_rsp_streams():
    """The RSP draws of the default source: (K,) uniforms in [0, 1) and K
    distinct clients; adding their streams re-seeded none of the others."""
    a, b = PhiloxSource(5, "cpu"), PhiloxSource(5, "cpu")
    u = a.rsp_uniforms(0, 7)
    idx = a.rsp_wor_indices(0, 30, 7)
    assert u.shape == (7,) and bool(((u >= 0) & (u < 1)).all())
    assert idx.shape == (7,) and len(set(idx.tolist())) == 7 and int(idx.max()) < 30
    assert not torch.equal(a.rsp_uniforms(1, 7), u)  # the stream moves on
    assert torch.equal(a.isp_uniforms(0, 30), b.isp_uniforms(0, 30))
    assert torch.equal(a.cohort_priorities(0, 30), b.cohort_priorities(0, 30))


def test_draw_input_by_procedure():
    src = PhiloxSource(0, "cpu")
    assert samplers.draw_input(src, "isp", 0, 20, 4).shape == (20,)
    assert samplers.draw_input(src, "rsp_wr", 0, 20, 4).dtype == torch.float32
    assert samplers.draw_input(src, "rsp_wor", 0, 20, 4).dtype == torch.int64
    with pytest.raises(ValueError, match="unknown procedure"):
        samplers.draw_input(src, "nope", 0, 20, 4)


def test_rsp_union_cohort_keeps_count_weights():
    """The deployable cohort takes an RSP draw's union mask and the count
    weights unchanged (``select_cohort`` needs no RSP case): its valid slots
    equal the reference's, with and without overflow."""
    n, budget = 40, 12
    rng = np.random.default_rng(5)
    lam = rng.dirichlet(np.ones(n)).astype(np.float32)
    p = rng.lognormal(0, 1, n).astype(np.float32)
    p /= p.sum()
    key = jax.random.PRNGKey(11)
    d_r = ref_samplers._rsp_wr_draw(key, jnp.asarray(p), budget)
    assert int(np.asarray(d_r.counts).max()) > 1  # a client drawn twice
    w_r = ref_estimator.client_weights(d_r, jnp.asarray(lam), "rsp_wr", budget)
    d_p = samplers._rsp_wr_draw(
        torch.from_numpy(np.asarray(jax.random.uniform(key, (budget,)))), torch.from_numpy(p), budget
    )
    w_p = estimator.client_weights(d_p, torch.from_numpy(lam), "rsp_wr", budget)
    prio_key = jax.random.fold_in(key, 1)
    prio = np.asarray(jax.random.uniform(prio_key, (n,)))
    for c in (16, 4):  # room for the union; overflow
        s_r = ref_cohort.select_cohort(d_r.mask, w_r, c, prio_key)
        s_p = cohort.select_cohort(d_p.mask, w_p, c, torch.from_numpy(prio))
        valid = np.asarray(s_r.valid)
        np.testing.assert_array_equal(s_p.valid.numpy(), valid)
        np.testing.assert_array_equal(s_p.ids.numpy()[valid], np.asarray(s_r.ids)[valid])
        np.testing.assert_allclose(s_p.weights.numpy(), np.asarray(s_r.weights), rtol=1e-6)
        assert int(s_p.n_dropped) == int(s_r.n_dropped)


@pytest.fixture
def rsp_log(monkeypatch):
    """Every (uniforms, draw_probs) pair the port's RSP draw sees."""
    log = []
    real = samplers._rsp_wr_draw

    def recording(uniforms, draw_probs, budget):
        log.append((uniforms.numpy().copy(), draw_probs.numpy().copy()))
        return real(uniforms, draw_probs, budget)

    monkeypatch.setattr(samplers, "_rsp_wr_draw", recording)
    return log


def _with_sampler(ref_spec, name: str, kwargs: dict):
    return ref_api.ExperimentSpec.from_dict(
        {**ref_spec.to_dict(), "sampler": {"name": name, "kwargs": kwargs}}
    )


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_params_close(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize(
    "name,task,oracle",
    [("uniform_rsp", "logreg", True), ("vrb", "logreg", True), ("mabs", "logreg", True),
     ("avare", "logreg", True), ("osmd", "logreg", True), ("vrb", "tiny_lm", False),
     ("optimal_isp", "logreg", True), ("clustered_kvib", "logreg", False)],
)
def test_run_matches_reference(name, task, oracle, rsp_log):
    """``api.run`` against ``repro.api.run`` on the reference's replayed
    draws: cohort sizes exact; loss, the estimator's squared error and the
    regret costs per round, and the final parameters, within tolerance."""
    kwargs = {"cluster_ids": (0, 1, 2, 3) * 4} if name == "clustered_kvib" else {}
    ref_spec = _with_sampler(_spec(task, oracle), name, kwargs)
    ref_built = ref_api.build(ref_spec)
    want = ref_api.run(ref_spec, built=ref_built)
    spec = api.ExperimentSpec.from_json(ref_spec.to_json())
    got = api.run(spec, device="cpu", random_source=jax_replay(ref_built))

    budget = ref_built.fed_config.budget
    for u, p in rsp_log:  # no draw hinges on the two packages' prefix-sum rounding
        cum = np.cumsum(p.astype(np.float64))
        assert np.min(np.abs((cum[-1] * (1.0 - u))[:, None] - cum[None, :])) > 1e-6
        assert u.shape == (budget,)
    assert got.cohort_size == want.cohort_size
    assert got.cohort_dropped == want.cohort_dropped
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    if oracle:
        np.testing.assert_allclose(got.estimator_sq_error, want.estimator_sq_error, **METRIC_TOL)
        np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
        np.testing.assert_allclose(got.regret.opt_costs, want.regret.opt_costs, **METRIC_TOL)
    _assert_params_close(got.final_params, want.final_params)


@pytest.mark.parametrize("name", NAMES)
def test_every_sampler_runs_deployable(name):
    """Every registry name runs in deployable mode on the port's own
    random source: finite loss, a cohort within its slots."""
    spec = api.ExperimentSpec.from_json(_with_sampler(_spec("logreg", False), name, {}).to_json())
    hist = api.run(spec, device="cpu")
    assert all(np.isfinite(hist.train_loss))
    assert all(0 <= c <= 2 for c in hist.cohort_size)  # _spec's cohort=2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_sampler_rounds_match_cpu(cuda, name):
    """Five sampler rounds on the card equal the same rounds on the CPU from
    the same draw inputs and feedback: masks and counts exact, probabilities
    and state within f32 tolerance."""
    n, budget = 1000, 32
    kw = {"cluster_ids": tuple(i % 17 for i in range(n))} if name == "clustered_kvib" else {}
    s = samplers.make_sampler(name, n, budget, **kw)
    rng = np.random.default_rng(1)
    st = {dev: s.init(dev) for dev in ("cpu", cuda)}
    for _ in range(5):
        if s.procedure == "isp":
            inp = rng.uniform(size=n).astype(np.float32)
        elif s.procedure == "rsp_wr":
            inp = rng.uniform(size=budget).astype(np.float32)
        else:
            inp = rng.permutation(n)[:budget]
        fb_all = rng.lognormal(0, 1, n).astype(np.float32)
        out = {}
        for dev in ("cpu", cuda):
            p = s.probabilities(st[dev])
            d = s.sample_from(p, torch.as_tensor(inp, device=dev))
            fb = torch.as_tensor(fb_all, device=dev) * d.mask
            st[dev] = s.update(st[dev], d, fb)
            out[dev] = (p, d)
        (p_c, d_c), (p_g, d_g) = out["cpu"], out[cuda]
        torch.testing.assert_close(p_g.cpu(), p_c, **TOL)
        assert torch.equal(d_g.mask.cpu(), d_c.mask) and torch.equal(d_g.counts.cpu(), d_c.counts)
        for f in ("stats", "aux"):
            a, b = getattr(st[cuda], f).cpu(), getattr(st["cpu"], f)
            assert torch.equal(torch.isfinite(a), torch.isfinite(b))
            torch.testing.assert_close(a[torch.isfinite(b)], b[torch.isfinite(b)], **TOL)
