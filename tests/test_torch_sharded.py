"""The port's sharded K-Vib solve and its kernel against the JAX reference,
on the CPU.

* kernel 5's plain version (``waterfill_level_stats`` on CPU tensors)
  against ``repro.kernels.ref.waterfill_stats_reference`` and the Pallas
  kernel in interpret mode: counts exact, ``mid_sum`` within 1e-5 relative
  (another summation order);
* one shard: the sharded solve, bisection or kernel ladder, is bitwise equal
  to the port's single-device ``_isp_solve`` (the snap recomputes the active
  sets with the same expressions), and equal to the reference's sharded
  solve at the solver's f32 tolerance (rtol 1e-5, atol 1e-7);
* two shards, two processes over gloo: within 1e-6 of the single-device
  solve (the middle sum is reassociated), with sum(p) = K to 1e-4;
* K-Vib trajectories and ``api.run`` with ``execution.sampler_axis``.

The CUDA kernel runs only on a GPU: the test marked ``cuda`` holds it against
the plain version there and skips elsewhere.
"""
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import make_sampler as ref_make_sampler  # noqa: E402
from repro.core import solver as ref_solver  # noqa: E402
from repro.kernels.ref import waterfill_stats_reference as ref_stats  # noqa: E402
from repro.kernels.sharded_waterfill import waterfill_level_stats as ref_kernel  # noqa: E402
from repro.launch.mesh import ShardSpec as RefShardSpec  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import make_sampler, solver  # noqa: E402
from repro_torch.kernels import ref, sharded_waterfill  # noqa: E402
from repro_torch.launch.mesh import ShardSpec  # noqa: E402
from test_torch_compression import _leaves  # noqa: E402
from test_torch_slice import METRIC_TOL, PARAM_TOL, _spec, jax_replay  # noqa: E402
from test_torch_waterfill import edge_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-7)  # the solver's f32 tolerance


def _stats_inputs(m, n_levels, seed, n_inf=0):
    rng = np.random.default_rng(seed)
    scores = rng.gamma(2.0, 1.0, size=m).astype(np.float32)
    scores[rng.permutation(m)[:n_inf]] = np.inf
    levels = np.sort(rng.gamma(2.0, 1.0, size=n_levels)).astype(np.float32)
    floors = (levels * np.float32(0.05)).astype(np.float32)
    return scores, levels, floors


@pytest.mark.parametrize(
    "m,n_levels,n_inf",
    [(1, 1, 0), (7, 3, 0), (128, 5, 0), (300, 17, 11), (2049, 128, 5), (5000, 130, 400)],
)
def test_plain_stats_match_reference_and_pallas(m, n_levels, n_inf):
    scores, levels, floors = _stats_inputs(m, n_levels, m + n_levels, n_inf)
    got = sharded_waterfill.waterfill_level_stats(
        torch.from_numpy(scores), torch.from_numpy(levels), torch.from_numpy(floors)
    )
    j = (jnp.asarray(scores), jnp.asarray(levels), jnp.asarray(floors))
    for want in (ref_stats(*j), ref_kernel(*j, interpret=True)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    assert all(x.dtype == torch.float32 and x.shape == (n_levels,) for x in got)


def test_plain_stats_chunking_is_exact_and_inf_is_inert():
    """Chunking does not change the counts, and +inf entries count nowhere
    (the reference's padding contract)."""
    scores = torch.tensor([1.0, 2.0, float("inf"), float("inf")])
    levels = torch.tensor([1.5, 100.0])
    floors = torch.tensor([0.1, 5.0])
    for chunk in (1, 3, 1 << 16):
        n_below, n_floor, mid = ref.waterfill_stats_reference(scores, levels, floors, chunk=chunk)
        assert n_below.tolist() == [1.0, 2.0]
        assert n_floor.tolist() == [0.0, 2.0]
        assert mid.tolist() == [1.0, 0.0]


@pytest.mark.parametrize(
    "scores,levels,floors,match",
    [
        (torch.ones(4, dtype=torch.float64), torch.ones(2), torch.ones(2), "float32"),
        (torch.ones(2, 2), torch.ones(2), torch.ones(2), "1-D"),
        (torch.ones(0), torch.ones(2), torch.ones(2), "non-empty"),
        (torch.ones(4), torch.ones(2), torch.ones(3), "floors must have shape"),
        (torch.ones(8)[::2], torch.ones(2), torch.ones(2), "contiguous"),
        (torch.ones(4), torch.ones(0), torch.ones(0), "non-empty"),
    ],
    ids=["dtype", "rank", "empty", "floors", "strided", "no_levels"],
)
def test_wrapper_rejects_bad_inputs(scores, levels, floors, match):
    with pytest.raises(ValueError, match=match):
        sharded_waterfill.waterfill_level_stats(scores, levels, floors)


def _solve_cases(count, seed=42):
    rng = np.random.default_rng(seed)
    primes = [13, 31, 61, 97, 127, 251]
    for k in range(count):
        n = primes[k % len(primes)] if k % 2 else int(rng.integers(5, 300))
        budget = int(rng.integers(1, n))
        p_min = float(rng.uniform(0.0, 0.9)) * budget / n
        a = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
        if k % 4 == 0:
            a[: n // 3] = 0.0  # zero scores sit at the floor
        yield n, budget, p_min, a


@pytest.mark.parametrize("use_kernel", [False, True], ids=["bisect", "kernel"])
def test_single_shard_solve_bitwise_equal(use_kernel):
    """S=1: bitwise the port's single-device solve, and the reference's
    sharded solve at the solver's tolerance."""
    for n, budget, p_min, a in _solve_cases(12):
        t = torch.from_numpy(a)
        want = solver.isp_probabilities(t, budget, p_min)
        got = solver.isp_probabilities(t, budget, p_min, shard=ShardSpec(), use_kernel=use_kernel)
        assert torch.equal(got, want), (n, budget, p_min)
        ref = ref_solver.isp_probabilities(
            jnp.asarray(a), budget, p_min, shard=RefShardSpec(), use_kernel=use_kernel
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_degenerate_budget_full_participation():
    a = torch.tensor([0.0, 1.0, 2.0])
    for use_kernel in (False, True):
        got = solver.isp_probabilities(a, 3, 0.0, shard=ShardSpec(), use_kernel=use_kernel)
        assert got.tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize(
    "scores,budget,p_min,match",
    [
        (np.ones(8, np.float32), 9, 0.0, "budget"),
        (np.ones(8, np.float32), 0, 0.0, "budget"),
        (np.ones(8, np.float32), 2, 0.5, "p_min"),
        (np.array([1.0, np.nan, 1.0], np.float32), 2, 0.0, "finite"),
        (np.array([1.0, np.inf, 1.0], np.float32), 2, 0.0, "finite"),
        (np.array([1.0, -0.5, 1.0], np.float32), 2, 0.0, "negative"),
    ],
)
def test_sharded_solve_rejects_invalid_host_inputs(scores, budget, p_min, match):
    for fn, shard, arr in (
        (ref_solver.isp_probabilities, RefShardSpec(), jnp.asarray(scores)),
        (solver.isp_probabilities, ShardSpec(), torch.from_numpy(scores)),
    ):
        with pytest.raises(ValueError, match=match):
            fn(arr, budget, p_min, shard=shard)


def test_use_kernel_default_follows_the_device(monkeypatch):
    """use_kernel=None: off for CPU tensors (no ladder pass), on when asked
    (five passes of the kernel a solve)."""
    calls = []
    real = solver.waterfill_level_stats

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(solver, "waterfill_level_stats", counting)
    a = torch.from_numpy(np.random.default_rng(0).gamma(2.0, 1.0, 40).astype(np.float32))
    solver.isp_probabilities(a, 7, 0.01, shard=ShardSpec())
    assert calls == []
    solver.isp_probabilities(a, 7, 0.01, shard=ShardSpec(), use_kernel=True)
    assert len(calls) == 5


def test_shard_spec_layout_and_process_group():
    s = ShardSpec(axes=(("data", 4), ("model", 2)), axis="model")
    assert s.num_shards == 2
    assert ShardSpec.from_manifest(s.to_manifest()) == s
    assert s.to_manifest() == RefShardSpec(axes=(("data", 4), ("model", 2)), axis="model").to_manifest()
    with pytest.raises(ValueError, match="not a mesh axis"):
        ShardSpec(axes=(("data", 2),), axis="model")
    assert ShardSpec().process_group() is None
    assert ShardSpec.from_process_group("data") == ShardSpec()  # no process group here
    with pytest.raises(ValueError, match="not initialised"):
        ShardSpec(axes=(("data", 2),)).process_group()


_GLOO_WORKER = textwrap.dedent(
    """
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import solver
    from repro_torch.launch.mesh import ShardSpec

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
        timeout=datetime.timedelta(seconds=60),
    )
    shard = ShardSpec(axes=(("data", 2),))
    try:
        ShardSpec(axes=(("data", 3),)).process_group()
        raise SystemExit("a 3-shard layout took a 2-rank group")
    except ValueError:
        pass
    rng = np.random.default_rng(0)
    worst, sums = 0.0, []
    for seed in range(10):
        a = torch.from_numpy(rng.gamma(2.0, 1.0, size=13).astype(np.float32))
        want = solver.isp_probabilities(a, 5, 0.05)
        for use_kernel in (False, True):
            got = solver.isp_probabilities(a, 5, 0.05, shard=shard, use_kernel=use_kernel)
            worst = max(worst, float((got - want).abs().max()))
            sums.append(float(got.sum()))
    spec = api.ExperimentSpec.from_json(sys.argv[3])
    built = api.build(spec, "cpu")
    hist = api.run(spec, "cpu", built=built)
    print(json.dumps({
        "rank": rank, "worst": worst, "sums": sums, "shards": built.sampler.shard.num_shards,
        "loss": hist.train_loss, "cohort": hist.cohort_size,
    }))
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_shards_over_gloo(tmp_path):
    """S=2 in two processes, prime N=13 (the +inf padding path): within 1e-6
    of the single-device solve, sum(p) = K; api.run with sampler_axis on a
    (2, 1) mesh splits the client axis over the group and follows the
    unsharded run.  (The host mesh of two ranks is (1, 2), both ranks on the
    model axis, so the spec names the (2, 1) mesh.)"""
    script = tmp_path / "worker.py"
    script.write_text(_GLOO_WORKER)
    spec = api.ExperimentSpec.from_json(_spec("logreg", oracle=True).to_json())
    d = spec.to_dict()
    sharded = api.ExperimentSpec.from_dict(
        {**d, "execution": {**d["execution"], "sampler_axis": "data", "mesh_shape": [2, 1]}})
    port = _free_port()
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(rank), str(port), sharded.to_json(indent=None)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    plain = api.run(spec, "cpu")
    for res in outs:
        assert res["shards"] == 2
        assert res["worst"] <= 1e-6, res["worst"]
        assert all(abs(s - 5.0) < 1e-4 for s in res["sums"])
        assert res["cohort"] == plain.cohort_size
        np.testing.assert_allclose(res["loss"], plain.train_loss, **METRIC_TOL)
    assert outs[0]["loss"] == outs[1]["loss"]


def test_kvib_trajectory_with_and_without_shard():
    """Three rounds of K-Vib on the reference's own uniforms and feedback:
    the sharded sampler's probabilities are bitwise the unsharded ones, and
    the reference's at the solver's tolerance.  The reference sampler is the
    unsharded one: its sharded form fails under the installed JAX (see
    ``test_run_with_sampler_axis``)."""
    n, budget, rounds = 13, 4, 3
    plain = make_sampler("kvib", n=n, budget=budget, horizon=rounds)
    sharded = make_sampler("kvib", n=n, budget=budget, horizon=rounds, shard=ShardSpec())
    ref = ref_make_sampler("kvib", n=n, budget=budget, horizon=rounds)

    @jax.jit
    def ref_step(state, key):
        p = ref.probabilities(state)
        draw = ref.sample_from(p, key)
        fb = draw.mask * (1.0 + jnp.arange(n, dtype=jnp.float32))
        return ref.update(state, draw, fb), p

    st_p, st_s, st_r = plain.init("cpu"), sharded.init("cpu"), ref.init()
    fb = torch.arange(1, n + 1, dtype=torch.float32)
    for t in range(rounds):
        key = jax.random.PRNGKey(100 + t)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
        st_r, p_r = ref_step(st_r, key)
        p_p, p_s = plain.probabilities(st_p), sharded.probabilities(st_s)
        assert torch.equal(p_p, p_s)
        np.testing.assert_allclose(p_s.numpy(), np.asarray(p_r), **F32_TOL)
        d_p, d_s = plain.sample_from(p_p, u), sharded.sample_from(p_s, u)
        np.testing.assert_array_equal(d_s.mask.numpy(), np.asarray(ref.sample_from(p_r, key).mask))
        st_p = plain.update(st_p, d_p, d_p.mask * fb)
        st_s = sharded.update(st_s, d_s, d_s.mask * fb)
        for a, b in ((st_p.stats, st_s.stats), (st_p.aux, st_s.aux)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "deployable"])
def test_run_with_sampler_axis(oracle):
    """api.run with execution.sampler_axis: bitwise the port's run without
    it, and on the reference's replayed draws the reference's run.

    The reference's own sampler_axis path fails under the installed JAX
    (``Sampler.shard_constrain``'s ``with_sharding_constraint`` refuses the
    Explicit-axis mesh that ``jax.make_mesh`` now builds; the reference's
    tests/test_sharded_sampler.py fails on it too), so the reference run is
    the same spec without the axis, which the reference's S=1 contract makes
    bitwise equal to it."""
    ref_spec = _spec("logreg", oracle)
    ref_built = ref_api.build(ref_spec)
    want = ref_api.run(ref_spec, built=ref_built)
    d = api.ExperimentSpec.from_json(ref_spec.to_json()).to_dict()
    spec = api.ExperimentSpec.from_dict({**d, "execution": {**d["execution"], "sampler_axis": "data"}})
    built = api.build(spec, "cpu")
    assert built.sampler.shard == ShardSpec()
    got = api.run(spec, "cpu", built=built, random_source=jax_replay(ref_built))
    plain = api.run(api.ExperimentSpec.from_dict(d), "cpu", random_source=jax_replay(ref_built))

    assert got.train_loss == plain.train_loss and got.cohort_size == plain.cohort_size
    for a, b in zip(_leaves(got.final_params), _leaves(plain.final_params)):
        np.testing.assert_array_equal(a, b)
    assert got.cohort_size == want.cohort_size
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    if oracle:
        np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
    for a, b in zip(_leaves(got.final_params), _leaves(want.final_params)):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,m,n_levels",
    [("gamma", 100, 128), ("gamma", 2048, 128), ("gamma", 1_000_003, 100),
     ("gamma", 300_000, 300), ("sorted", 1_000_000, 128), ("sorted", 100_000, 128),
     ("almost_sorted", 100_000, 128), ("shuffled", 1_000_000, 128), ("ties", 50_000, 128),
     ("floors_ge_levels", 20_000, 128), ("shuffled_levels", 70_001, 128),
     ("special", 30_000, 64), ("special", 2_000, 8), ("special", 200, 8),
     ("shuffled", 256, 128)],
)
def test_cuda_kernel_matches_plain(cuda, case, m, n_levels):
    """Counts exact, mid_sum within 1e-5 relative, bitwise repeatable, one
    launch a call: gamma scores with +inf entries, then
    ``test_torch_waterfill.edge_inputs``' cases (sorted, the sort-free path;
    one pair out of order a chunk; shuffled; ties at levels and floors;
    floors at or above levels; a shuffled ladder; -inf, NaN, +-0.0), and
    single blocks of at most 256 scores (every level against every score)."""
    if case == "gamma":
        scores, levels, floors = _stats_inputs(m, n_levels, m, n_inf=m // 50)
    else:
        scores, levels, floors = edge_inputs(case, m, n_levels, seed=m)
    s, lv, fl = (torch.from_numpy(x).to(cuda) for x in (scores, levels, floors))
    sharded_waterfill.reset_launch_counts()
    got = torch.stack(sharded_waterfill.waterfill_level_stats(s, lv, fl))
    again = torch.stack(sharded_waterfill.waterfill_level_stats(s, lv, fl))
    want = torch.stack(ref.waterfill_stats_reference(s, lv, fl))
    torch.cuda.synchronize()
    assert sharded_waterfill.launch_counts() == {"waterfill_level_stats": 2}
    assert torch.equal(got[:2], want[:2])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0.0)
    assert torch.equal(got, again)
