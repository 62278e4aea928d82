"""The RSP samplers with the fault layer and compression, and three samplers
with ``sampler_axis``, against the reference on its replayed draws.

36 combinations, each in oracle and deployable mode:

* vrb, uniform_rsp, mabs, osmd and avare, each with Markov availability +
  an exponential deadline + buffered async, with Bernoulli availability +
  int8 deltas (error feedback) + the quantized async ring, and with int8 +
  error feedback alone;
* optimal_isp, clustered_kvib and vrb with ``execution.sampler_axis``.

The reference's own ``sampler_axis`` path fails under the installed JAX
(``tests/test_torch_sharded.py``), so those cases hold the port's sharded
run to the reference's run without the axis.  One recording of the
reference's run and draws per case is shared by the two tests (a
module-scoped fixture): counts exact, values within the slice's tolerances
(compressed parameters within one int8 step of the run's movement, as
``tests/test_torch_faults.py`` holds them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.fed.tasks import params_to_numpy  # noqa: E402
from test_torch_compression import STEP, _leaves  # noqa: E402
from test_torch_slice import METRIC_TOL, PARAM_TOL, _spec, jax_replay  # noqa: E402

ROUNDS = 4
SECTIONS = {
    "markov_deadline_async": {
        "fault": {"availability": "markov", "availability_kwargs": {"p_on": 0.6, "p_off": 0.3},
                  "deadline": 1.2, "latency": "exponential", "async_buffer": 4}},
    "bernoulli_int8_async": {
        "fault": {"availability": "bernoulli", "availability_kwargs": {"q": 0.7},
                  "async_buffer": 4, "round_time": 0.5},
        "compression": {"delta_dtype": "int8"}},
    "int8_ef": {"compression": {"delta_dtype": "int8", "error_feedback": True}},
    "sampler_axis": {"execution": {"sampler_axis": "data"}},
}
CASES = [(name, sec) for name in ("vrb", "uniform_rsp", "mabs", "osmd", "avare")
         for sec in ("markov_deadline_async", "bernoulli_int8_async", "int8_ef")]
CASES += [(name, "sampler_axis") for name in ("optimal_isp", "clustered_kvib", "vrb")]
CASES = [(name, sec, oracle) for name, sec in CASES for oracle in (True, False)]
IDS = [f"{n}-{s}-{'oracle' if o else 'deployable'}" for n, s, o in CASES]


def _case_spec(name, section, oracle):
    """(port spec, reference spec): the reference's has no sampler_axis."""
    d = _spec("logreg", oracle).to_dict()
    kwargs = {"cluster_ids": (0, 1, 2, 3) * 4} if name == "clustered_kvib" else {}
    d["sampler"] = {"name": name, "kwargs": kwargs}
    d["federation"] = {**d["federation"], "rounds": ROUNDS}
    for key, fields in SECTIONS[section].items():
        d[key] = {**d.get(key, {}), **fields}
    port = api.ExperimentSpec.from_dict(d)
    d["execution"] = {**d["execution"], "sampler_axis": None}
    return port, ref_api.ExperimentSpec.from_dict(d)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def recorded(request):
    """One case's reference run, its replayed draws and the port's run."""
    name, section, oracle = request.param
    spec, ref_spec = _case_spec(name, section, oracle)
    ref_built = ref_api.build(ref_spec)
    want = ref_api.run(ref_spec, built=ref_built)
    replay = jax_replay(ref_built)
    got = api.run(spec, device="cpu", random_source=replay)
    return spec, want, got, params_to_numpy(replay.init_params(None))


def test_counts_match_reference(recorded):
    spec, want, got, _ = recorded
    assert len(got.train_loss) == ROUNDS
    assert got.cohort_size == want.cohort_size
    assert got.cohort_dropped == want.cohort_dropped
    assert got.deadline_dropped == want.deadline_dropped


def test_values_match_reference(recorded):
    spec, want, got, init = recorded
    np.testing.assert_allclose(got.train_loss, want.train_loss, **METRIC_TOL)
    if spec.execution.oracle_metrics:
        np.testing.assert_allclose(got.estimator_sq_error, want.estimator_sq_error, **METRIC_TOL)
        np.testing.assert_allclose(got.regret.costs, want.regret.costs, **METRIC_TOL)
        np.testing.assert_allclose(got.regret.opt_costs, want.regret.opt_costs, **METRIC_TOL)
    final = _leaves(want.final_params)
    if not spec.compression.enabled:
        for a, b in zip(_leaves(got.final_params), final):
            np.testing.assert_allclose(a, b, **PARAM_TOL)
        return
    movement = max(float(np.abs(f - i).max()) for f, i in zip(final, _leaves(init)))
    for a, b in zip(_leaves(got.final_params), final):
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=STEP[spec.compression.delta_dtype] * movement
        )
