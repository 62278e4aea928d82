"""The port's water-filling solver and samplers against the reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import regret as ref_regret  # noqa: E402
from repro.core import samplers as ref_samplers  # noqa: E402
from repro.core import solver as ref_solver  # noqa: E402
from repro_torch.core import regret, samplers, solver  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-7)


def _grid(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "lognormal":
        return rng.lognormal(0.0, 1.5, 64).astype(np.float32)
    if name == "ties":
        return np.repeat(rng.uniform(0.1, 2.0, 8), 6).astype(np.float32)
    if name == "zeros":
        s = rng.uniform(0.0, 1.0, 40).astype(np.float32)
        s[::3] = 0.0
        return s
    if name == "saturation":  # a few dominant clients cap at p = 1
        s = rng.uniform(0.01, 0.1, 50).astype(np.float32)
        s[:4] = [1e3, 5e2, 2e2, 1e2]
        return s
    raise KeyError(name)


@pytest.mark.parametrize("name", ["lognormal", "ties", "zeros", "saturation"])
@pytest.mark.parametrize("budget_frac,p_min_frac", [(0.1, 0.0), (0.25, 0.5), (1.0, 0.0)])
def test_isp_probabilities_match(name, budget_frac, p_min_frac):
    scores = _grid(name)
    n = scores.shape[0]
    budget = max(1, int(round(budget_frac * n)))  # budget_frac 1.0: K == N
    p_min = p_min_frac * budget / n
    want = np.asarray(ref_solver.isp_probabilities(jnp.asarray(scores), budget, p_min))
    got = solver.isp_probabilities(torch.from_numpy(scores), budget, p_min).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got.sum(), budget, rtol=1e-5)


@pytest.mark.parametrize(
    "scores,budget,p_min,match",
    [
        ([1.0, 2.0], 0, 0.0, "budget"),
        ([1.0, 2.0], 3, 0.0, "budget"),
        ([1.0, 2.0], 1, 0.9, "p_min"),
        ([1.0, -2.0], 1, 0.0, "non-negative"),
        ([1.0, float("nan")], 1, 0.0, "finite"),
    ],
)
def test_isp_probabilities_rejects_like_reference(scores, budget, p_min, match):
    with pytest.raises(ValueError, match=match):
        ref_solver.isp_probabilities(jnp.asarray(scores, jnp.float32), budget, p_min)
    with pytest.raises(ValueError, match=match):
        solver.isp_probabilities(torch.tensor(scores), budget, p_min)


def test_rsp_mix_and_costs_match():
    scores = _grid("saturation")
    s_j, s_t = jnp.asarray(scores), torch.from_numpy(scores)
    np.testing.assert_allclose(
        solver.rsp_probabilities(s_t, 5).numpy(),
        np.asarray(ref_solver.rsp_probabilities(s_j, 5)),
        **F32_TOL,
    )
    p = np.array(ref_solver.isp_probabilities(s_j, 5))
    np.testing.assert_array_equal(
        solver.mix_probabilities(torch.from_numpy(p), 0.3, 5).numpy(),
        np.asarray(ref_solver.mix_probabilities(jnp.asarray(p), 0.3, 5)),
    )
    cost, opt = regret.round_costs(s_t, torch.from_numpy(p), 5)
    cost_r, opt_r = ref_regret.round_costs(s_j, jnp.asarray(p), 5)
    np.testing.assert_allclose(float(cost), float(cost_r), rtol=1e-5)
    np.testing.assert_allclose(float(opt), float(opt_r), rtol=1e-5)


@pytest.mark.parametrize("name,kw", [("kvib", {"horizon": 5}), ("kvib", {"gamma": 0.5, "p_min": 0.01}), ("uniform_isp", {})])
def test_sampler_trajectory_matches(name, kw):
    """Five rounds of probabilities -> draw -> update, the port fed the
    uniforms the reference draws from its keys, and the same feedback."""
    n, budget = 24, 4
    ref = ref_samplers.make_sampler(name, n, budget, **kw)
    pt = samplers.make_sampler(name, n, budget, **kw)
    st_r, st_p = ref.init(), pt.init("cpu")
    rng = np.random.default_rng(0)
    for t in range(5):
        key = jax.random.PRNGKey(100 + t)
        p_r = ref.probabilities(st_r)
        p_p = pt.probabilities(st_p)
        np.testing.assert_allclose(p_p.numpy(), np.asarray(p_r), **F32_TOL)
        u = np.array(jax.random.uniform(key, (n,)))
        assert np.min(np.abs(u - np.asarray(p_r))) > 1e-5  # no mask bit on a knife edge
        d_r = ref.sample_from(p_r, key)
        d_p = pt.sample_from(p_p, torch.from_numpy(u))
        np.testing.assert_array_equal(d_p.mask.numpy(), np.asarray(d_r.mask))
        assert int(d_p.size) == int(d_r.size)
        fb = (rng.lognormal(0, 1, n) * np.asarray(d_r.mask)).astype(np.float32)
        st_r = ref.update(st_r, d_r, jnp.asarray(fb))
        st_p = pt.update(st_p, d_p, torch.from_numpy(fb))
        np.testing.assert_allclose(st_p.stats.numpy(), np.asarray(st_r.stats), **F32_TOL)
        np.testing.assert_allclose(st_p.aux.numpy(), np.asarray(st_r.aux), **F32_TOL)
        assert int(st_p.t) == int(st_r.t)


def test_unported_samplers_point_to_roadmap():
    """Every sampler of the reference's registry is ported: the port takes
    the same nine names, and an unknown name raises as the reference's
    registry does."""
    assert samplers.sampler_names() == ref_samplers.sampler_names()
    assert len(samplers.sampler_names()) == 9
    for mod in (ref_samplers, samplers):
        with pytest.raises(ValueError, match="unknown sampler"):
            mod.make_sampler("nope", 8, 2)
