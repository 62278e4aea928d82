"""The port's compressed client deltas against the JAX reference, on the CPU.

The quantizer must give the reference's codes and scales bit for bit; the
plain version of kernel 4 must agree with the Pallas kernel run in interpret
mode; ``aggregate_compressed`` with ``repro.core.estimator``'s; and
``repro_torch.api.run`` with an enabled compression section must follow
``repro.api.run`` round by round on the reference's replayed draws
(``test_torch_slice.jax_replay``).

Tolerance of the runs: the deltas of the two packages differ by float
rounding (another summation order), and a code flips where a scaled value
sits on a rounding boundary.  One flip moves one element of the estimate by
one quantization step, so the final parameters are held to about one step of
the run's parameter movement, not to f32 rounding; losses and squared errors
keep the uncompressed slice's bound, well above what a flip moves them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import estimator as ref_estimator  # noqa: E402
from repro.kernels.fused_weighted_agg import (  # noqa: E402
    dequantize_stacked as ref_dequantize,
    fused_dequant_cohort_agg as ref_dequant_agg,
    quantize_stacked as ref_quantize,
)
from repro_torch import api  # noqa: E402
from repro_torch.core import estimator  # noqa: E402
from repro_torch.fed.tasks import params_to_numpy  # noqa: E402
from repro_torch.kernels import fused_weighted_agg as fwa  # noqa: E402
from test_torch_slice import ROUNDS, _spec, jax_replay  # noqa: E402

DTYPES = ["int8", "fp8"]
# Relative spacing of the codes at the top of a block: int8 one step of
# absmax / 127; fp8 e4m3 3 mantissa bits, 2**-3 of the value.
STEP = {"int8": 1.0 / 127.0, "fp8": 2.0**-3}
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)


def _codes(q) -> np.ndarray:
    """int8 or fp8 codes, either package, as raw bytes."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _to_torch_codes(q) -> torch.Tensor:
    raw = torch.from_numpy(_codes(q).copy())
    return raw.view(torch.int8 if np.asarray(q).dtype == np.int8 else torch.float8_e4m3fn)


def _flat(c, d, seed):
    x = (np.random.default_rng(seed).standard_normal((c, d)) * 3.0).astype(np.float32)
    x[0] = 0.0  # an all-zero slot: scale 1.0, codes 0
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,d,sb", [(4, 640, 128), (7, 123, 128), (3, 256, 64), (3, 1000, 40)])
def test_quantize_bitwise_matches_reference(dtype, c, d, sb):
    x = _flat(c, d, seed=c * d)
    q_r, s_r = ref_quantize(jnp.asarray(x), dtype=dtype, scale_block=sb)
    q_p, s_p = fwa.quantize_stacked(torch.from_numpy(x), dtype=dtype, scale_block=sb)
    assert q_p.dtype == fwa.quant_dtype(dtype) and q_p.shape == q_r.shape
    np.testing.assert_array_equal(_codes(q_p), _codes(q_r))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(
        fwa.dequantize_stacked(q_p, s_p).numpy(), np.asarray(ref_dequantize(q_r, s_r))
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_zero_rows_and_saturation(dtype):
    """Zero slots get scale 1.0; each block's abs-max lands on the
    saturation code; bitwise the reference's."""
    x = np.zeros((2, 256), np.float32)
    x[1, 3] = 5.0
    x[1, 200] = -7.5
    q_p, s_p = fwa.quantize_stacked(torch.from_numpy(x), dtype=dtype)
    q_r, s_r = ref_quantize(jnp.asarray(x), dtype=dtype)
    np.testing.assert_array_equal(_codes(q_p), _codes(q_r))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
    assert s_p[0].tolist() == [1.0, 1.0]
    deq = fwa.dequantize_stacked(q_p, s_p).numpy()
    assert float(q_p.to(torch.float32).abs().max()) == fwa._QMAX[dtype]
    np.testing.assert_allclose(deq[1, [3, 200]], [5.0, -7.5], rtol=1e-6)
    assert not deq[0].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "c,d,sb,bd", [(4, 4096, 128, 1024), (3, 2048, 128, 2048), (8, 1024, 64, 256), (2, 512, 128, 512)]
)
def test_dequant_plain_matches_pallas(dtype, c, d, sb, bd):
    """Kernel 4's plain version against the Pallas kernel (interpret mode)
    on the same codes and scales."""
    rng = np.random.default_rng(c + d)
    x = rng.standard_normal((c, d)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, c).astype(np.float32)
    lam = rng.uniform(0.0, 0.3, c).astype(np.float32)
    q, scales = ref_quantize(jnp.asarray(x), dtype=dtype, scale_block=sb)
    want = ref_dequant_agg(q, scales, jnp.asarray(w), jnp.asarray(lam), block_d=bd, interpret=True)
    got = fwa.fused_dequant_cohort_agg(
        _to_torch_codes(q), torch.from_numpy(np.array(scales)), torch.from_numpy(w),
        torch.from_numpy(lam),
    )
    assert [tuple(t.shape) for t in got] == [(d,), (), (c,)]
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


class _Comp:
    """Duck-typed CompressionSpec, as both estimators take it."""

    def __init__(self, delta_dtype, scale_block=128):
        self.delta_dtype, self.scale_block = delta_dtype, scale_block


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_resid", [True, False], ids=["resid", "no_resid"])
def test_aggregate_compressed_matches_reference(dtype, with_resid):
    rng = np.random.default_rng(5)
    c = 5
    ups = {
        "w": rng.standard_normal((c, 30, 10)).astype(np.float32),
        "b": {"x": rng.standard_normal((c, 7)).astype(np.float32)},
    }
    w = np.array([1.3, 0.4, 2.0, 0.7, 0.0], np.float32)
    lam = np.array([0.1, 0.05, 0.2, 0.3, 0.0], np.float32)
    d_dim = 307
    resid = (rng.standard_normal(d_dim) * 0.01).astype(np.float32) if with_resid else None
    comp = _Comp(dtype, scale_block=40)  # D_pad = 320: padded tail, ragged blocks

    def to(tree, fn):
        return {k: to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}

    ref = ref_estimator.aggregate_compressed(
        to(ups, jnp.asarray), jnp.asarray(w), jnp.asarray(lam), comp,
        None if resid is None else jnp.asarray(resid),
    )
    got = estimator.aggregate_compressed(
        to(ups, torch.from_numpy), torch.from_numpy(w), torch.from_numpy(lam), comp,
        None if resid is None else torch.from_numpy(resid),
    )
    for a, b in zip(_leaves(got[0]), _leaves(ref[0])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    if not with_resid:
        assert got[3] is None and ref[3] is None
        return
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-5, atol=1e-6)
    # Telescoping: the raw estimate plus the new residual is the f32 aggregate.
    flat, _ = estimator.flatten_stacked(to(ups, torch.from_numpy))
    d_true = torch.from_numpy(w) @ flat
    applied = torch.from_numpy(np.concatenate([x.reshape(-1) for x in _leaves(got[0])]))
    d_hat = applied - torch.from_numpy(resid)
    np.testing.assert_allclose((d_hat + got[3]).numpy(), d_true.numpy(), rtol=1e-5, atol=1e-6)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _compressed(ref_spec, **comp):
    return ref_api.ExperimentSpec.from_dict({**ref_spec.to_dict(), "compression": comp})


@pytest.mark.parametrize(
    "comp", [{"delta_dtype": "int8"}, {"delta_dtype": "fp8", "error_feedback": False}],
    ids=["int8_ef", "fp8_no_ef"],
)
@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "deployable"])
@pytest.mark.parametrize("task", ["logreg", "tiny_lm"])
def test_compressed_run_matches_reference(task, oracle, comp):
    ref_spec = _compressed(_spec(task, oracle), **comp)
    ref_built = ref_api.build(ref_spec)
    want = ref_api.run(ref_spec, built=ref_built)
    replay = jax_replay(ref_built)
    got = api.run(api.ExperimentSpec.from_json(ref_spec.to_json()), device="cpu", random_source=replay)

    assert len(got.train_loss) == ROUNDS
    assert got.cohort_size == want.cohort_size
    assert got.cohort_dropped == want.cohort_dropped
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    if oracle:
        np.testing.assert_allclose(got.estimator_sq_error, want.estimator_sq_error, **METRIC_TOL)
        np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
    init = _leaves(params_to_numpy(replay.init_params(None)))
    final = _leaves(want.final_params)
    movement = max(float(np.abs(f - i).max()) for f, i in zip(final, init))
    atol = STEP[comp["delta_dtype"]] * movement
    for a, b in zip(_leaves(got.final_params), final):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


def test_error_feedback_follows_reference():
    """The reference's error-feedback spec (tests/test_compression.py:
    25 rounds, uniform_isp, int8 with and without EF): the port's final
    losses equal the reference's own, rather than meeting that test's
    2e-3 distance to the f32 run."""
    base = ref_api.ExperimentSpec(
        task=ref_api.TaskSpec(
            name="logreg", dataset="synthetic_classification",
            dataset_kwargs=dict(n_clients=12, total=600, seed=7),
        ),
        sampler=ref_api.SamplerSpec(name="uniform_isp"),
        federation=ref_api.FederationSpec(
            rounds=25, budget=4, local_steps=2, batch_size=16, local_lr=0.05
        ),
        execution=ref_api.ExecutionSpec(seed=11),
    )
    final = {}
    for ef in (True, False):
        ref_spec = _compressed(base, delta_dtype="int8", error_feedback=ef)
        ref_built = ref_api.build(ref_spec)
        want = ref_api.run(ref_spec, built=ref_built)
        got = api.run(
            api.ExperimentSpec.from_json(ref_spec.to_json()), device="cpu",
            random_source=jax_replay(ref_built),
        )
        assert got.cohort_size == want.cohort_size
        np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
        final[ef] = (got.train_loss[-1], want.train_loss[-1])
    # Error feedback changes the run in both packages alike.
    assert final[True][0] != final[False][0]


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "deployable"])
def test_compiled_and_eager_agree_compressed(oracle):
    """compiled=True and compiled=False give bitwise-equal compressed runs,
    with the residual in the carry (tests/test_compression.py:251)."""
    spec = api.ExperimentSpec.from_json(
        _compressed(_spec("logreg", oracle), delta_dtype="int8").to_json()
    )
    d = spec.to_dict()
    eager = api.ExperimentSpec.from_dict({**d, "execution": {**d["execution"], "compiled": False}})
    a = api.run(spec, device="cpu")
    b = api.run(eager, device="cpu")
    assert a.train_loss == b.train_loss and a.cohort_size == b.cohort_size
    assert a.estimator_sq_error == b.estimator_sq_error
    for x, y in zip(_leaves(a.final_params), _leaves(b.final_params)):
        np.testing.assert_array_equal(x, y)
