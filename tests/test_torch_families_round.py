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
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_zoo_round import (  # noqa: E402
    FAMILY_ARCHS,
    check_round_modes,
    check_round_step,
    check_run,
    check_run_on_card,
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILY_ARCHS))
def test_zoo_run_on_card_matches_cpu(arch, cuda):
    check_run_on_card(arch, cuda)
