"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

``--dump-spec`` prints the reference launcher's spec for the same flags
(the dicts equal, ``config_fingerprint`` the same 16 hex digits in both
packages, and a ``spec.json`` written by one package reads back in the
other with the same fingerprint).  Within the port: ``--spec`` reproduces
the flag-driven run bitwise; ``--compiled --ckpt --ckpt-every`` writes
``spec.json`` before round 0 and the manifest at every boundary; a run
SIGKILLed after its first segment (``REPRO_KILL_AFTER_SEGMENTS=1``, in a
subprocess) and resumed with ``--resume`` ends bitwise where the
uninterrupted run ends; the host loop and the compiled path, on one random
source, pick the same cohorts and follow the same losses.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import ExperimentSpec as RefSpec  # noqa: E402
from repro.checkpoint import config_fingerprint as ref_fingerprint  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro_torch.api import ExperimentSpec  # noqa: E402
from repro_torch.checkpoint import config_fingerprint  # noqa: E402
from repro_torch.checkpoint.checkpointer import tree_flatten  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
LOSS_RTOL = 1e-5  # the zoo round's tolerance (tests/test_torch_zoo_round.py)
FAULTS = json.dumps({"availability": "markov", "availability_kwargs": {"p_on": 0.7, "p_off": 0.2},
                     "deadline": 1.0})
# The reduced smollm (2 blocks, d_model 128, vocab 512, f32) at a CPU size.
SMALL = ["--arch", "smollm-360m", "--reduced", "--rounds", "4", "--clients", "8",
         "--budget", "2", "--cohort", "3", "--seq", "16", "--local-batch", "2"]

FLAG_SETS = {
    "plain": [],
    "faults": ["--faults", FAULTS, "--compiled"],
    "int8_no_ef": ["--delta-dtype", "int8", "--no-error-feedback", "--compiled"],
    "shard_sampler": ["--shard-sampler", "data"],
    "reduced_vrb": SMALL + ["--sampler", "vrb", "--local-lr", "0.1", "--ckpt-every", "2"],
    "fp8_seed": ["--delta-dtype", "fp8", "--seed", "3", "--local-steps", "1", "--compiled"],
    "qwen3_moe": ["--arch", "qwen3-moe-235b-a22b", "--compiled", "--cohort", "4"],
    "arctic_reduced": ["--arch", "arctic-480b"] + SMALL[2:] + ["--compiled"],
    "xlstm_int8": ["--arch", "xlstm-125m", "--delta-dtype", "int8", "--compiled"],
}
# The moe and xlstm families at the reduced CPU size of SMALL.
FAMILY_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b", "xlstm-125m"]


def _dump(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--dump-spec"])
    return buf.getvalue()


@pytest.mark.parametrize("case", list(FLAG_SETS))
def test_dump_spec_equals_the_reference(case):
    argv = FLAG_SETS[case]
    got, want = json.loads(_dump(train.main, argv)), json.loads(_dump(ref_train.main, argv))
    assert got == want
    assert config_fingerprint(got) == ref_fingerprint(want)
    assert config_fingerprint(ExperimentSpec.from_dict(got).to_dict()) == ref_fingerprint(
        RefSpec.from_dict(want).to_dict())


def test_spec_json_round_trips_across_packages(tmp_path):
    """A ``spec.json`` written by one process and read by another gives
    the same fingerprint: floats print alike in both ``to_json``."""
    args = train.make_parser().parse_args(FLAG_SETS["faults"] + ["--local-lr", "0.07"])
    spec = train.build_spec_from_args(args)
    path = spec.save(str(tmp_path / "spec.json"))
    fp = config_fingerprint(spec.to_dict())
    assert config_fingerprint(ExperimentSpec.load(path).to_dict()) == fp
    assert ref_fingerprint(RefSpec.load(path).to_dict()) == fp
    RefSpec.load(path).save(str(tmp_path / "ref.json"))
    assert (tmp_path / "ref.json").read_text() == Path(path).read_text()


def _leaves(path):
    with np.load(path) as z:
        return [z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[1]))]


def _assert_npz_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_spec_file_reproduces_the_flag_run_bitwise(tmp_path, capsys):
    flags = SMALL + ["--compiled", "--device", "cpu"]
    train.main(flags + ["--ckpt", str(tmp_path / "flags")])
    (tmp_path / "exp.json").write_text(_dump(train.main, SMALL + ["--compiled"]))
    capsys.readouterr()
    out = train.main(["--spec", str(tmp_path / "exp.json"), "--ckpt", str(tmp_path / "spec"),
                      "--device", "cpu", "--arch", "ignored"])
    _assert_npz_equal(tmp_path / "flags.npz", tmp_path / "spec.npz")
    printed = capsys.readouterr().out
    assert "compiled segments on one device: cpu" in printed and "round   3 loss=" in printed
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))


def test_compiled_ckpt_writes_spec_before_round_zero(tmp_path, monkeypatch):
    seen = []
    real = train.run_segmented

    def spy(state, *a, **kw):
        d = tmp_path / "fl_ckpts"
        seen.append(((d / "spec.json").exists(), (d / "manifest.json").exists(), state.round))
        return real(state, *a, **kw)

    monkeypatch.setattr(train, "run_segmented", spy)
    train.main(SMALL + ["--compiled", "--ckpt", str(tmp_path / "fl"), "--ckpt-every", "2",
                        "--device", "cpu"])
    assert seen == [(True, False, 0)]
    d = tmp_path / "fl_ckpts"
    spec = ExperimentSpec.load(str(d / "spec.json"))
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["steps"] == [2, 4] and manifest["step"] == 4
    assert manifest["config_fingerprint"] == config_fingerprint(spec.to_dict())
    assert spec.execution.ckpt_every == 2 and spec.execution.compiled
    assert (tmp_path / "fl.npz").exists()


def test_sigkill_then_resume_is_bitwise_the_uninterrupted_run(tmp_path, capsys):
    flags = SMALL + ["--compiled", "--ckpt-every", "2", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": SRC, "REPRO_KILL_AFTER_SEGMENTS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *flags, "--ckpt", str(tmp_path / "k")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "REPRO_KILL_AFTER_SEGMENTS=1: SIGKILL" in proc.stdout
    manifest = json.loads((tmp_path / "k_ckpts" / "manifest.json").read_text())
    assert manifest["steps"] == [2] and not (tmp_path / "k.npz").exists()
    capsys.readouterr()
    resumed = train.main(flags + ["--ckpt", str(tmp_path / "k"), "--resume"])
    assert "resumed from checkpoint step 2 (2 rounds remaining)" in capsys.readouterr().out
    full = train.main(flags + ["--ckpt", str(tmp_path / "full")])
    _assert_npz_equal(tmp_path / "k.npz", tmp_path / "full.npz")
    assert resumed["losses"] == full["losses"] and resumed["cohorts"] == full["cohorts"]


def test_host_loop_and_compiled_path_draw_alike(capsys):
    args = train.make_parser().parse_args(SMALL + ["--rounds", "3"])
    spec = train.build_spec_from_args(args)
    host = train.run_spec(spec, device="cpu")
    printed = capsys.readouterr().out
    compiled = train.run_spec(ExperimentSpec.from_dict(
        {**spec.to_dict(), "execution": {**spec.to_dict()["execution"], "compiled": True}}),
        device="cpu")
    assert host["cohorts"] == compiled["cohorts"] and sum(host["cohorts"]) > 0
    np.testing.assert_allclose(host["losses"], compiled["losses"], rtol=LOSS_RTOL)
    for a, b in zip(tree_flatten(host["params"]), tree_flatten(compiled["params"])):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale
    assert "p[min/max]=" in printed and "round   2 loss=" in printed


@pytest.mark.parametrize("extra", [["--delta-dtype", "int8"], ["--shard-sampler", "data"]],
                         ids=["int8", "shard_sampler"])
def test_compiled_sections_run(extra):
    """The sections whose kernels this launcher reaches on the card
    (``--delta-dtype``: kernel 4; ``--shard-sampler``: kernel 5) run here
    on their plain versions."""
    out = train.main(SMALL + ["--rounds", "2", "--compiled", "--device", "cpu"] + extra)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_families_host_loop_and_compiled_path_draw_alike(arch, capsys):
    """``launch.train --arch`` runs the moe and xlstm families with no change
    of flags: the host loop and the compiled path, on one random source,
    pick the same cohorts and follow the same losses."""
    flags = ["--arch", arch] + SMALL[2:] + ["--rounds", "2"]
    spec = train.build_spec_from_args(train.make_parser().parse_args(flags))
    host = train.run_spec(spec, device="cpu")
    compiled = train.main(flags + ["--compiled", "--device", "cpu"])
    assert host["cohorts"] == compiled["cohorts"] and sum(host["cohorts"]) > 0
    np.testing.assert_allclose(host["losses"], compiled["losses"], rtol=LOSS_RTOL)
    assert all(np.isfinite(compiled["losses"]))
    assert f"arch={arch}-reduced" in capsys.readouterr().out


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="fault injection"):
        train.main(SMALL + ["--faults", FAULTS, "--device", "cpu"])
    with pytest.raises(SystemExit, match="delta compression"):
        train.main(SMALL + ["--delta-dtype", "int8", "--device", "cpu"])
    with pytest.raises(SystemExit) as err:  # ap.error: usage, exit code 2
        train.main(SMALL + ["--resume", "--device", "cpu"])
    assert err.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(SMALL)


def test_host_loop_snapshots(tmp_path, capsys):
    train.main(SMALL + ["--ckpt", str(tmp_path / "h"), "--ckpt-every", "2", "--device", "cpu"])
    for name in ("h_r2.npz", "h_r4.npz", "h.npz"):
        assert (tmp_path / name).exists()
    _assert_npz_equal(tmp_path / "h_r4.npz", tmp_path / "h.npz")
    assert "  checkpoint ->" in capsys.readouterr().out


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_loop_and_compiled_agree_on_card(cuda):
    """On the card (kernels 6-7 forward): the host loop and the compiled
    path pick the same cohorts and losses from one Philox source, and a
    second compiled run is bitwise the first."""
    args = train.make_parser().parse_args(SMALL + ["--rounds", "3"])
    spec = train.build_spec_from_args(args)
    host = train.run_spec(spec, device=cuda)
    comp_spec = ExperimentSpec.from_dict(
        {**spec.to_dict(), "execution": {**spec.to_dict()["execution"], "compiled": True}})
    a = train.run_spec(comp_spec, device=cuda)
    b = train.run_spec(comp_spec, device=cuda)
    assert host["cohorts"] == a["cohorts"]
    np.testing.assert_allclose(host["losses"], a["losses"], rtol=1e-5)
    assert a["losses"] == b["losses"]
    for x, y in zip(tree_flatten(a["params"]), tree_flatten(b["params"])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_sigkill_resume_on_card(tmp_path, cuda):
    flags = SMALL + ["--compiled", "--ckpt-every", "2"]
    env = {**os.environ, "PYTHONPATH": SRC, "REPRO_KILL_AFTER_SEGMENTS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *flags, "--ckpt", str(tmp_path / "k")],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == -9, proc.stderr[-2000:]
    train.main(flags + ["--ckpt", str(tmp_path / "k"), "--resume"])
    train.main(flags + ["--ckpt", str(tmp_path / "full")])
    _assert_npz_equal(tmp_path / "k.npz", tmp_path / "full.npz")
