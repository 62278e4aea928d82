"""The zoo federated round over the moe and xlstm families against the JAX
reference on the CPU (the cases of ``tests/test_torch_zoo_round.py`` for
``FAMILY_ARCHS``, in a file of their own so that the test runner can
spread the two files' work).

Reduced f32 configs: qwen3-moe-235b-a22b (dropless, and with
``capacity_factor=0.5``: capacity drops in every round), arctic-480b (dense
residual) and xlstm-125m.  The round step in both modes on the
reference's weights; ``api.run`` with ``kind="zoo"`` on the reference's
recorded draws, plain, faulted and with ``sampler_axis``: counts exact,
losses within 1e-5, parameters within 1e-5 of each leaf's scale (the
xLSTM runs within ``rtol=1e-5, atol=1e-4``, ROADMAP.md's f32 rule).
An xLSTM run with int8 deltas is held on the reference's own codes
(``test_xlstm_int8_run_matches_reference_on_its_codes``).
"""
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.api import runner as ref_runner  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import estimator  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402
from test_torch_zoo_round import (  # noqa: E402
    FAMILY_ARCHS,
    LOSS_RTOL,
    PARAM_TOL,
    check_round_modes,
    check_round_step,
    check_run,
    check_run_on_card,
    one_intraop_thread,  # noqa: F401  (the module's autouse fixture)
    spec_dict,
    zoo_replay,
)

STEP_ARCHS = ["moe", "xlstm"]  # the round step in both modes; all four run below

RUN_CASES = {
    "plain_moe": ("moe", {}, None),
    "moe_drops_markov_deadline_async": (
        "moe_drops", {"fault": {"availability": "markov", "deadline": 1.2, "async_buffer": 4}},
        None),
    "arctic_sampler_axis": ("arctic", {}, {"execution": {"sampler_axis": "data"}}),
    "plain_xlstm": ("xlstm", {}, None),
    "xlstm_bernoulli_deadline": (
        "xlstm", {"fault": {"availability": "bernoulli", "availability_kwargs": {"q": 0.8},
                            "deadline": 1.2}}, None),
}


@pytest.mark.parametrize("mode", ["client_parallel", "cohort_sequential"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_round_step_matches_reference(arch, mode):
    check_round_step(arch, mode)


@pytest.mark.parametrize("arch", list(FAMILY_ARCHS))
def test_round_modes_agree_and_zero_weight_slot_is_inert(arch):
    check_round_modes(arch)


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_matches_reference(case):
    arch, sections, port_sections = RUN_CASES[case]
    want = check_run(arch, sections, port_sections)
    if case == "moe_drops_markov_deadline_async":
        assert sum(want.deadline_dropped) > 0


def test_xlstm_int8_run_matches_reference_on_its_codes():
    """xlstm-125m with int8 deltas and error feedback.  The two packages'
    deltas differ by f32 rounding, and a code flips where the scaled delta
    straddles a rounding boundary: one quantization step (the block's
    absmax / 127) at that element.  Given the reference's codes (recorded
    in its run with ``jax.debug.callback``), the port follows it within the
    file's xLSTM tolerances (losses ``LOSS_RTOL``, parameters ``PARAM_TOL``
    elementwise), so the flips are the whole gap; the port's own round-0
    codes, from the same weights, each lie within one step of the
    reference's."""
    d = spec_dict("xlstm", compression={"delta_dtype": "int8", "error_feedback": True})
    ref_spec = ref_api.ExperimentSpec.from_dict(d)
    ref_built = ref_api.build(ref_spec)
    fwa = importlib.import_module("repro.kernels.fused_weighted_agg")
    quantize, codes = fwa.quantize_stacked, []

    def recording(flat, **kw):
        q, scales = quantize(flat, **kw)
        jax.debug.callback(lambda q, s: codes.append((np.asarray(q), np.asarray(s))), q, scales,
                           ordered=True)
        return q, scales

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_runner, "_make_mesh", lambda spec: None)  # as run_both does
        mp.setattr(fwa, "quantize_stacked", recording)
        want = ref_api.run(ref_spec, built=ref_built)
    rounds = d["federation"]["rounds"]
    assert len(codes) == rounds
    replayed = iter(codes)
    own = []
    port_quantize = estimator.quantize_stacked

    def replaying(flat, **kw):
        own.append(port_quantize(flat, **kw)[0])  # the port's own codes, for the count
        return tuple(torch.from_numpy(a.copy()) for a in next(replayed))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(estimator, "quantize_stacked", replaying)
        got = api.run(api.ExperimentSpec.from_dict(d), "cpu", random_source=zoo_replay(ref_built))
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=LOSS_RTOL)
    for g, w in zip(tree_leaves(got.final_params), jax.tree_util.tree_leaves(want.final_params)):
        np.testing.assert_allclose(g, np.asarray(w), **PARAM_TOL)
    # Round 0 starts from the same weights in both packages: its codes
    # differ only where a scaled delta straddles a rounding boundary, by one.
    flips = np.abs(own[0].numpy().astype(np.int32) - codes[0][0].astype(np.int32))
    assert flips.max() <= 1 and 0 < flips.sum() < flips.size


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILY_ARCHS))
def test_zoo_run_on_card_matches_cpu(arch, cuda):
    check_run_on_card(arch, cuda)
