"""The client axis over several ranks: the port's host meshes and
``fed/state.py:build_placement`` against the reference's, then the task and
zoo rounds split over a two-rank gloo group against the port at S = 1.

* the mesh helpers (``make_host_mesh``, ``REPRO_MESH_SHAPE``,
  ``batch_axes``, ``fsdp_axes``) against ``repro.launch.mesh`` at one
  device in-process and at four in a subprocess
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``);
* ``build_placement`` leaf by leaf (the split dimension or replicated)
  against the reference's on the same shapes, on a (2, 2) CPU mesh split
  over ``data`` (S = 2), at N = 12 and 13;
* one gloo worker pair (``tests/torch_ranks_worker.py``, two processes,
  ``mesh_shape=(2, 1)``) runs every case once; each case is held against
  the same spec run here at S = 1: floats within 1e-6 (relative to the
  largest magnitude of the array; parameters 1e-6 of each leaf's largest
  entry), counts and masks exact, both ranks' results bitwise equal.  K-Vib
  oracle and deployable are also held against the reference's unsharded
  run on its replayed draws, at the f32 tolerances.  Checkpoints move
  between S = 2 and S = 1 both ways, and a resume at S = 2 is bitwise the
  uninterrupted S = 2 run.  The int8 run of ``chip_smoke.py``'s (r2)
  (tiny_lm deployable, markov availability, a deadline, the async ring)
  at S = 2 is handed the codes its S = 1 run wrote
  (``torch_ranks_worker.quantizer_codes``, a test-side patch of the
  quantizer) and then follows S = 1 within the f32 tolerance: flipped
  codes are the whole gap between them.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import make_sampler, sampler_names  # noqa: E402
from repro_torch.fed.server import build_segment_runner  # noqa: E402
from repro_torch.fed.state import build_placement, run_segmented  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.mesh import ShardSpec  # noqa: E402
from test_torch_slice import jax_replay  # noqa: E402
from test_torch_zoo_round import one_intraop_thread  # noqa: E402, F401

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks_worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 4
REL_TOL = 1e-6  # S = 2 against S = 1: relative to each array's largest magnitude
# The MoE rounds at S = 2 also sum the gates over the ranks and scale each
# rank's share of the aux's gradient by whole / local rows and back: their
# zero-init norm leaves, all update, move 1.1e-6 to 1.8e-6 of their scale.
MOE_TOL = 1e-5
F32_TOL = dict(rtol=1e-5, atol=1e-4)  # against the reference


# -- the mesh helpers -----------------------------------------------------------


@pytest.mark.parametrize("override", [None, "1,1"])
def test_host_mesh_one_device_matches_reference(monkeypatch, override):
    if override is None:
        monkeypatch.delenv("REPRO_MESH_SHAPE", raising=False)
    else:
        monkeypatch.setenv("REPRO_MESH_SHAPE", override)
    want, got = ref_mesh.make_host_mesh(), mesh.make_host_mesh()
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    assert mesh.batch_axes(got) == ref_mesh.batch_axes(want)
    assert mesh.fsdp_axes(got) == ref_mesh.fsdp_axes(want)
    assert got.device_mesh() is None  # one rank: no DeviceMesh, no group
    want_shard = ref_mesh.ShardSpec.from_mesh(want)
    assert ShardSpec.from_mesh(got).to_manifest() == want_shard.to_manifest()


_MESH_PROBE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    from repro.launch import mesh as m
    out = {}
    for override in ["", "2,1", "1,4", "2,2", "4,1", "1,2,2", "2,2,1"]:
        os.environ["REPRO_MESH_SHAPE"] = override
        host = m.make_host_mesh()
        prod = m.make_production_mesh(multi_pod=True) if override else None
        out[override] = {
            "shape": list(host.devices.shape), "axes": list(host.axis_names),
            "batch": list(m.batch_axes(host)), "fsdp": list(m.fsdp_axes(host)),
            "prod": None if prod is None else [list(prod.devices.shape), list(prod.axis_names)],
        }
    print("RESULT", json.dumps(out))
    """
)


def test_host_mesh_four_devices_matches_reference(monkeypatch):
    """Four host devices (the reference) against four ranks (the port):
    the model axis takes the largest of (16, 8, 4, 2, 1) dividing 4; every
    override parses to the same axes and sizes."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _MESH_PROBE], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.split("RESULT", 1)[1])
    for override, ref in want.items():
        if override:
            monkeypatch.setenv("REPRO_MESH_SHAPE", override)
        else:
            monkeypatch.delenv("REPRO_MESH_SHAPE", raising=False)
        host = mesh.make_host_mesh(world=4)
        assert [list(host.sizes), list(host.axis_names)] == [ref["shape"], ref["axes"]], override
        assert list(mesh.batch_axes(host)) == ref["batch"]
        assert list(mesh.fsdp_axes(host)) == ref["fsdp"]
        if ref["prod"] is not None:
            prod = mesh.make_production_mesh(multi_pod=True)
            assert [list(prod.sizes), list(prod.axis_names)] == ref["prod"]
    monkeypatch.delenv("REPRO_MESH_SHAPE", raising=False)
    assert mesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}


def test_shard_spec_blocks_and_identities():
    s = ShardSpec(axes=(("data", 2), ("model", 1)), axis="data")
    assert s.num_shards == 2 and s.splits
    assert [s.local_range(13, r) for r in range(2)] == [(0, 7), (7, 13)]
    assert [s.local_range(12, r) for r in range(2)] == [(0, 6), (6, 12)]
    pod = ShardSpec(axes=(("pod", 2), ("data", 2), ("model", 1)), axis=("pod", "data"))
    assert pod.num_shards == 4 and [pod.local_range(10, r) for r in range(4)] == [
        (0, 3), (3, 6), (6, 9), (9, 10)]
    assert ShardSpec.from_manifest(pod.to_manifest()) == pod
    one = ShardSpec()
    x = torch.arange(5.0)
    assert one.sum(x) is x and one.gather(x, 5) is x and one.rank() == 0 and not one.splits
    with pytest.raises(ValueError, match="not initialised"):
        s.rank()


# -- build_placement against the reference's ------------------------------------

_PLACEMENT_CASES = {
    "oracle_scores_12": dict(n=12, oracle=True),
    "oracle_scores_13": dict(n=13, oracle=True),
    "markov_async_12": dict(n=12, oracle=True, fault={"availability": "markov", "async_buffer": 3}),
    "markov_async_13": dict(n=13, oracle=False,
                            fault={"availability": "markov", "async_buffer": 3}),
    "int8_ef_12": dict(n=12, oracle=True, compression={"delta_dtype": "int8"}),
    "int8_ef_async_13": dict(n=13, oracle=True, compression={"delta_dtype": "int8"},
                             fault={"availability": "markov", "async_buffer": 2, "deadline": 2.0}),
}


def _placement_spec(n, oracle, fault=None, compression=None, rounds=ROUNDS) -> dict:
    d = {
        "task": {"name": "logreg", "dataset": "synthetic_classification",
                 "dataset_kwargs": {"n_clients": n, "total": 100 * n, "power": 2.0, "seed": 3}},
        "sampler": {"name": "kvib", "kwargs": {"horizon": rounds}},
        "federation": {"rounds": rounds, "budget": 3, "local_steps": 2, "batch_size": 16,
                       "local_lr": 0.05, "cohort": 4},
        "execution": {"seed": 1, "oracle_metrics": oracle},
    }
    if fault:
        d["fault"] = fault
    if compression:
        d["compression"] = compression
    return d


def _port_template(case):
    """The port's global round-0 state and its placement over a (2, 2)
    mesh split over data."""
    spec = api.ExperimentSpec.from_dict(_placement_spec(**case))
    state = api.restore_template(spec, device="cpu")
    sampler = make_sampler("kvib", n=case["n"], budget=3,
                           shard=ShardSpec(axes=(("data", 2), ("model", 2)), axis="data"))
    return state, build_placement(state, sampler)


_REF_PLACEMENT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    from repro import api
    from repro.core import make_sampler, stragglers
    from repro.fed.state import TrainState, build_placement
    from repro.launch.mesh import ShardSpec

    def sds(shape, dtype=jnp.float32):
        return jax.ShapeDtypeStruct(tuple(shape), dtype)

    def dim(s):
        return next((i for i, a in enumerate(s.spec) if a is not None), None)

    out = {}
    for name, case in json.loads(sys.argv[1]).items():
        n, d_dim = case["n"], case["d_dim"]
        spec = api.ExperimentSpec.from_dict(case["spec"])
        sampler = make_sampler("kvib", n=n, budget=3,
                               shard=ShardSpec(axes=(("data", 2), ("model", 2)), axis="data"))
        faults = ()
        if spec.fault.enabled:
            comp = spec.compression if spec.compression.enabled else None
            faults = jax.eval_shape(lambda: stragglers.fault_state_init(spec.fault, n, d_dim, comp))
        ef = spec.compression.enabled and spec.compression.error_feedback
        template = TrainState(
            params={k: sds(v) for k, v in case["params"].items()},
            opt_state=(), sampler=jax.eval_shape(sampler.init),
            metrics={k: sds(v) for k, v in case["metrics"].items()},
            round=sds((), jnp.int32), key=sds((2,), jnp.uint32), faults=faults,
            compression={"resid": sds((d_dim,))} if ef else (),
        )
        pl = build_placement(template, sampler)
        out[name] = {f: [dim(s) for s in jax.tree_util.tree_leaves(getattr(pl, f))]
                     for f in ("params", "sampler", "metrics", "faults", "compression")}
    print("RESULT", json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def ref_placements():
    cases = {}
    for name, case in _PLACEMENT_CASES.items():
        state, _ = _port_template(case)
        cases[name] = {
            "n": case["n"], "spec": _placement_spec(**case),
            "d_dim": sum(int(np.prod(v.shape)) for v in state.params.values()),
            "params": {k: list(v.shape) for k, v in state.params.items()},
            "metrics": {k: list(v.shape) for k, v in state.metrics.items()},
        }
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _REF_PLACEMENT, json.dumps(cases)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("name", sorted(_PLACEMENT_CASES))
def test_build_placement_matches_reference(name, ref_placements):
    """Leaf by leaf: the leading (N,) of the sampler's leaves and the chain,
    the trailing (N,) of the score history, split when 2 divides N and
    replicated otherwise; the rest replicated.  The port's key/source and
    round fields are replicated whole (None)."""
    state, pl = _port_template(_PLACEMENT_CASES[name])
    want = ref_placements[name]
    from repro_torch.checkpoint.checkpointer import tree_flatten

    for field, ref in want.items():
        mine = getattr(pl, field)
        got = [None] * len(ref) if mine is None else tree_flatten(mine)
        if field == "faults" and mine:  # the reference's dict order: sorted keys, as ours
            got = tree_flatten(mine)
        assert got == ref, (field, got, ref)
    n = _PLACEMENT_CASES[name]["n"]
    split = n % 2 == 0
    assert pl.sampler.stats == (0 if split else None)
    if "scores" in state.metrics:
        assert pl.metrics["scores"] == (1 if split else None)


# -- the worker pair -------------------------------------------------------------

_COHORT_SAMPLER_KW = {
    "kvib": {"horizon": ROUNDS}, "vrb": {"horizon": ROUNDS},
    "clustered_kvib": {"horizon": ROUNDS},
}


def _task(name="kvib", n=12, oracle=True, **sections) -> dict:
    d = _placement_spec(n, oracle, sections.pop("fault", None), sections.pop("compression", None))
    kw = dict(_COHORT_SAMPLER_KW.get(name, {}))
    if name == "clustered_kvib":
        kw["cluster_ids"] = [i % 3 for i in range(n)]
    d["sampler"] = {"name": name, "kwargs": kw}
    for section, over in sections.items():
        d[section] = {**d.get(section, {}), **over}
    return d


def _zoo(arch, kwargs, **fed) -> dict:
    return {
        "task": {"kind": "zoo", "name": arch, "reduced": True, "kwargs": kwargs,
                 "dataset": "synthetic_tokens",
                 "dataset_kwargs": {"n_clients": 8, "seq_len": 16, "total_seqs": 256}},
        "sampler": {"name": "kvib", "kwargs": {"horizon": 3}},
        "federation": {"rounds": 3, "budget": 2, "local_steps": 2, "local_lr": 0.05, **fed},
        "execution": {"seed": 5},
    }


SMOLLM = {"n_layers": 2, "d_model": 64, "d_ff": 128, "vocab": 128}
GEMMA = {"d_model": 64, "d_ff": 128, "vocab": 128}
# A local batch of 3 x 16 tokens, top 2 of 4 experts: 12 rows an expert for
# the whole batch drops pairs (a rank's own rows would give it 8 or 4).
QWEN3 = {"n_layers": 2, "d_model": 64, "vocab": 128, "capacity_factor": 0.5}
ARCTIC = {**QWEN3, "d_ff": 128}  # and its dense residual MLP
FAULTS = {"availability": "markov", "availability_kwargs": {"p_on": 0.7, "p_off": 0.3},
          "deadline": 1.2, "async_buffer": 3}
CKPT = dict(fault={"availability": "markov", "async_buffer": 3},
            compression={"delta_dtype": "int8"}, execution={"ckpt_every": 2})

CASES = {}
for _name in sampler_names():
    for _n in (12, 13):
        for _oracle in (True, False):
            CASES[f"{_name}_{'oracle' if _oracle else 'deploy'}_{_n}"] = _task(_name, _n, _oracle)
CASES.update({
    "int8_ef_oracle_12": _task(compression={"delta_dtype": "int8"}),
    "int8_ef_deploy_13": _task(n=13, oracle=False, compression={"delta_dtype": "int8"}),
    "fp8_deploy_12": _task(oracle=False, compression={"delta_dtype": "fp8",
                                                       "error_feedback": False}),
    "faults_deploy_13": _task(n=13, oracle=False, fault=FAULTS),
    "faults_oracle_12": _task(fault=FAULTS),
    "diurnal_deadline_oracle_13": _task(n=13, fault={"availability": "diurnal", "deadline": 2.0}),
    "bernoulli_q_deploy_12": _task(oracle=False, fault={
        "availability": "bernoulli",
        "availability_kwargs": {"q": [0.5 + 0.04 * i for i in range(12)]}}),
    "exact_oracle_equiv_12": _task(oracle=False, execution={"exact_oracle_equiv": True},
                                   federation={"cohort": 12}),
    "offload_oracle_13": _task(n=13, execution={"ckpt_every": 2,
                                                "score_history_host_offload": True}),
    "eager_oracle_13": _task(n=13, execution={"compiled": False}),
    "zoo_smollm_parallel": _zoo("smollm-360m", SMOLLM, cohort=3, batch_size=2),
    "zoo_smollm_int8": _zoo("smollm-360m", SMOLLM, cohort=3, batch_size=2),
    "zoo_gemma_sequential": _zoo("gemma2-27b", GEMMA, cohort=2, batch_size=3),
    # MoE cohort_sequential rounds over rows split 2 / 1: the whole batch's
    # capacity, slots and load-balance loss.
    "zoo_qwen3_sequential": _zoo("qwen3-moe-235b-a22b", QWEN3, cohort=2, batch_size=3),
    "zoo_arctic_sequential": _zoo("arctic-480b", ARCTIC, cohort=2, batch_size=3),
})
CASES["zoo_smollm_int8"]["compression"] = {"delta_dtype": "int8"}
CASES["zoo_smollm_parallel"]["fault"] = FAULTS
REF_CASES = {"kvib_ref_oracle_12": True, "kvib_ref_deploy_12": False}
# chip_smoke.py's (r2): tiny_lm deployable with Markov availability, an
# exponential deadline, the async ring of 4 and int8 deltas with error
# feedback, 5 rounds.  Its S = 2 run's own codes differ from S = 1's where
# a sum added in another order sits at a rounding boundary.
R2_INT8 = {
    "task": {"name": "tiny_lm", "kwargs": {"vocab": 256}, "dataset": "synthetic_tokens",
             "dataset_kwargs": {"n_clients": 50, "seq_len": 32, "vocab": 256, "total_seqs": 3000,
                                "power": 2.2, "seed": 0}},
    "sampler": {"name": "kvib", "kwargs": {"horizon": 5}},
    "federation": {"rounds": 5, "budget": 5, "local_steps": 1, "batch_size": 8, "local_lr": 0.3},
    "execution": {"seed": 0, "oracle_metrics": False, "sampler_axis": "data"},
    "fault": {"availability": "markov", "availability_kwargs": {"p_on": 0.6, "p_off": 0.2},
              "deadline": 1.2, "latency": "exponential", "async_buffer": 4},
    "compression": {"delta_dtype": "int8"},
}
# Checkpoints: (a) saved at S = 2, resumed at S = 1; (b) saved at S = 1 here,
# resumed at S = 2; (c) saved and resumed at S = 2.
CKPT_SPEC = _task(**CKPT)


def _with_mesh(d: dict) -> dict:
    return {**d, "execution": {**d.get("execution", {}), "mesh_shape": [2, 1]}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the worker pair (S = 2) and here (S = 1): name ->
    (rank 0's npz, rank 1's npz, the S = 1 result)."""
    tmp = tmp_path_factory.mktemp("ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases = [{"name": k, "spec": _with_mesh(v)} for k, v in CASES.items()]
        for name, oracle in REF_CASES.items():
            ref_spec = ref_api.ExperimentSpec.from_dict(_task(oracle=oracle))
            src = jax_replay(ref_api.build(ref_spec))
            path = tmp / f"{name}.pkl"
            path.write_bytes(pickle.dumps(src))
            cases.append({"name": name, "spec": _with_mesh(_task(oracle=oracle)),
                          "replay": str(path)})
        for n in (12, 13):
            cases.append({"name": f"layout_{n}", "kind": "layout",
                          "spec": _with_mesh(_task(n=n, fault={"availability": "markov"}))})
        # (b): this process saves a first segment at S = 1 before the pair starts.
        torch_ranks_worker.run_case({"kind": "interrupt", "spec": CKPT_SPEC, "dir": str(tmp / "b")})
        # (r2) at S = 1 records its codes before the pair starts; S = 2 is handed them.
        codes = str(tmp / "r2_codes.npz")
        r2_one = torch_ranks_worker.run_case({"spec": R2_INT8, "codes": codes, "record": True})
        cases.append({"name": "r2_int8_given_codes", "spec": _with_mesh(R2_INT8), "codes": codes})
        cases += [
            {"name": "ckpt_a_save", "kind": "interrupt", "spec": _with_mesh(CKPT_SPEC),
             "dir": str(tmp / "a")},
            {"name": "ckpt_b_resume", "kind": "resume", "spec": _with_mesh(CKPT_SPEC),
             "dir": str(tmp / "b")},
            {"name": "ckpt_c_save", "kind": "interrupt", "spec": _with_mesh(CKPT_SPEC),
             "dir": str(tmp / "c")},
            {"name": "ckpt_c_resume", "kind": "resume", "spec": _with_mesh(CKPT_SPEC),
             "dir": str(tmp / "c")},
            {"name": "ckpt_s2", "spec": _with_mesh(CKPT_SPEC)},
        ]
        (tmp / "cases.json").write_text(json.dumps(cases))
        port = _free_port()
        env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_ranks_worker.py"), str(r), "2",
             str(port), str(tmp / "cases.json"), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(2)]
        try:
            # The S = 1 runs here while the pair runs.
            ones = {}
            for case in cases:
                if case.get("kind", "run") == "run" and not case.get("codes"):
                    execution = {k: v for k, v in case["spec"]["execution"].items()
                                 if k != "mesh_shape"}
                    plain = {**case, "spec": {**case["spec"], "execution": execution}}
                    ones[case["name"]] = torch_ranks_worker.run_case(plain)
            ones["ckpt_s1"] = torch_ranks_worker.run_case({"spec": CKPT_SPEC})
            ones["r2_int8_given_codes"] = r2_one
            for p in procs:
                _, err = p.communicate(timeout=600)
                assert p.returncode == 0, err[-4000:]
        finally:
            for p in procs:
                p.kill()
        out = {}
        for case in cases:
            name = case["name"]
            r0, r1 = (dict(np.load(tmp / f"{name}_r{r}.npz")) for r in range(2))
            out[name] = (r0, r1, ones.get(name))
        # (a): resumed here at S = 1 from the pair's first segment.
        out["ckpt_a_resume_s1"] = torch_ranks_worker.run_case(
            {"kind": "resume", "spec": CKPT_SPEC, "dir": str(tmp / "a")})
        out["ckpt_s1"] = ones["ckpt_s1"]
    finally:
        torch.set_num_threads(threads)
    return out


def _close(got: dict, want: dict, tol: float = REL_TOL) -> None:
    """Every key of ``want`` in ``got``: integers exact, floats within
    ``tol`` of each array's largest magnitude."""
    for k, w in want.items():
        if k == "collectives":
            continue
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.size:
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(REF_CASES))
def test_split_run_matches_one_rank(name, ranks):
    r0, r1, one = ranks[name]
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"ranks differ: {k}")
    _close(r0, one, MOE_TOL if name.startswith(("zoo_qwen3", "zoo_arctic")) else REL_TOL)
    assert r0["collectives"].sum() > 0  # the split run went through collectives


def test_int8_split_run_follows_one_rank_given_its_codes(ranks):
    """(r2) with int8 deltas and error feedback at S = 2, handed the codes
    and scales its S = 1 run wrote, call for call (each rank its slots'
    rows of the estimator's, the async ring's row whole): every float
    within the f32 tolerance of S = 1, counts exact, both ranks bitwise.
    Some of the S = 2 run's own codes differ from the ones it is handed
    (the case exercises a flip)."""
    r0, r1, one = ranks["r2_int8_given_codes"]
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"ranks differ: {k}")
    assert len(r0["flips"]) == len(one["flips"]) == 2 * R2_INT8["federation"]["rounds"]
    assert r0["flips"].sum() > 0
    _close(r0, {k: v for k, v in one.items() if k != "flips"})
    assert r0["collectives"].sum() > 0


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "deploy"])
def test_kvib_split_matches_reference_on_its_draws(oracle, ranks):
    """The reference's unsharded K-Vib run on its own draws against the port
    split over two ranks on the same draws."""
    name = f"kvib_ref_{'oracle' if oracle else 'deploy'}_12"
    got = ranks[name][0]
    want = ref_api.run(ref_api.ExperimentSpec.from_dict(_task(oracle=oracle)))
    np.testing.assert_array_equal(got["cohort"], want.cohort_size)
    np.testing.assert_allclose(got["loss"], want.train_loss, **F32_TOL)
    if oracle:
        np.testing.assert_allclose(got["cost"], want.regret.costs, **F32_TOL)
        np.testing.assert_allclose(got["sq_error"], want.estimator_sq_error, **F32_TOL)
    flat = torch_ranks_worker._flat(jax.tree_util.tree_map(np.asarray, want.final_params))
    for k, w in flat.items():
        np.testing.assert_allclose(got[f"param.{k}"], w, **F32_TOL, err_msg=k)


@pytest.mark.parametrize("n", [12, 13])
def test_each_rank_holds_its_block(n, ranks):
    """S = 2 divides 12: each rank keeps 6 of every (N,) sampler and chain
    leaf, and (T, 6) score rows; 13 falls back to replicated at rest."""
    r0, r1, _ = ranks[f"layout_{n}"]
    want = n // 2 if n % 2 == 0 else n
    for r in (r0, r1):
        assert r["sampler.stats"].tolist() == [want] and r["sampler.aux"].tolist() == [want]
        assert r["faults.chain"].tolist() == [want]
        assert r["metrics.scores"].tolist() == [ROUNDS, want]
        assert r["metrics.train_loss"].tolist() == [ROUNDS]


def test_checkpoints_move_between_one_and_two_ranks(ranks):
    """(a) a first segment saved at S = 2 resumes at S = 1, (b) one saved at
    S = 1 resumes at S = 2: each within the S = 1 tolerance of the
    uninterrupted run; (c) saved and resumed at S = 2: bitwise the
    uninterrupted S = 2 run."""
    s1, s2 = ranks["ckpt_s1"], ranks["ckpt_s2"][0]
    assert int(ranks["ckpt_a_save"][0]["round"]) == 2
    a = ranks["ckpt_a_resume_s1"]
    assert int(a["resumed_from"]) == 2
    _close(a, s1)
    b = ranks["ckpt_b_resume"][0]
    assert int(b["resumed_from"]) == 2
    _close(b, s1)
    c = ranks["ckpt_c_resume"][0]
    assert int(c["resumed_from"]) == 2
    for k in s2:
        if k != "collectives":
            np.testing.assert_array_equal(c[k], s2[k], err_msg=k)
    _close(s2, s1)


def test_model_axis_and_missing_group_raise(monkeypatch):
    """model > 1 builds on a process group of the mesh's ranks (a ``fake``
    one here, rank 3 of 4): the sampler's ShardSpec splits the data axes
    over this rank's line of them (none at (1, 2) and (1, 1, 2)), and the
    model line is the rank's neighbours; without a group every mesh of
    more than one rank raises ValueError at build, on both stacks;
    REPRO_MESH_SHAPE reaches the mesh when mesh_shape is None."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    zoo = _zoo("smollm-360m", SMOLLM, cohort=3, batch_size=2)
    for d in (_task(), zoo):
        for shape in ([1, 2], [2, 2], [1, 1, 2]):
            spec = api.ExperimentSpec.from_dict(
                {**d, "execution": {**d["execution"], "mesh_shape": shape}})
            with pytest.raises(ValueError, match="not initialised"):
                api.build(spec, "cpu")
            world = int(np.prod(shape))
            dist.init_process_group("fake", store=FakeStore(), rank=world - 1, world_size=world)
            try:
                shard = api.build(spec, "cpu").sampler.shard
                m = mesh.make_mesh(shape)
                model = m.axis_group("model")
                assert (model.size, model.rank) == (2, 1)
                assert dist.get_process_group_ranks(model.pg) == [world - 2, world - 1]
                if shape == [2, 2]:
                    assert shard == ShardSpec.from_mesh(m, axis="data") and shard.rank() == 1
                    assert dist.get_process_group_ranks(shard.process_group()) == [1, 3]
                else:
                    assert shard is None
            finally:
                dist.destroy_process_group()
        with pytest.raises(ValueError, match="not initialised"):
            api.build(api.ExperimentSpec.from_dict(_with_mesh(d)), "cpu")
        monkeypatch.setenv("REPRO_MESH_SHAPE", "2,1")
        with pytest.raises(ValueError, match="not initialised"):
            api.build(api.ExperimentSpec.from_dict(d), "cpu")
        monkeypatch.delenv("REPRO_MESH_SHAPE")
        assert api.build(api.ExperimentSpec.from_dict(d), "cpu").sampler.shard is None


def test_one_rank_segment_is_unchanged():
    """At S = 1 the segment function has no layout and the run's buffers
    are written in place, as before."""
    spec = api.ExperimentSpec.from_dict(_task(n=13))
    built = api.build(spec, "cpu")
    segment, state = build_segment_runner(built.task, built.dataset, built.sampler,
                                          built.fed_config, device="cpu")
    assert segment.layout is None
    buf = state.metrics["scores"]
    out = run_segmented(state, ROUNDS, segment)
    assert out.metrics["scores"] is buf and out.sampler.stats.shape == (13,)


def test_each_rank_needs_work():
    """Over S ranks each rank needs at least one client, slot or batch row:
    a round narrower than S is refused before any collective."""
    from repro_torch.fed.round import build_fed_scan_segment

    shard = ShardSpec(axes=(("data", 2), ("model", 1)), axis="data")
    spec = api.ExperimentSpec.from_dict(_task(oracle=False, federation={"cohort": 1}))
    built = api.build(spec, "cpu")
    sampler = make_sampler("kvib", n=12, budget=3, shard=shard)
    with pytest.raises(ValueError, match="at least one"):
        build_segment_runner(built.task, built.dataset, sampler, built.fed_config, device="cpu")
    for fed in ({"cohort": 1, "batch_size": 2}, {"cohort": 2, "batch_size": 1}):
        d = _zoo("smollm-360m", SMOLLM, **fed)
        if fed["batch_size"] == 1:
            d["task"] = {**d["task"], "name": "gemma2-27b", "kwargs": GEMMA}
        zb = api.build(api.ExperimentSpec.from_dict(d), "cpu")
        with pytest.raises(ValueError, match="at least one"):
            build_fed_scan_segment(zb.arch_config, zb.round_spec,
                                   make_sampler("kvib", n=8, budget=2, shard=shard), zb.dataset,
                                   source=None)


def test_moe_sequential_round_does_not_split():
    """A MoE arch's load-balance loss and expert capacity couple a batch's
    rows, and its cohort_sequential round over S > 1 ranks does not split
    them: it builds at S = 2, and the cases ``zoo_qwen3_sequential`` and
    ``zoo_arctic_sequential`` run it through ``api.run`` on (2, 1) against
    S = 1 (``test_split_run_matches_one_rank``); over one rank it builds."""
    from repro_torch.configs import get_config
    from repro_torch.fed.round import RoundSpec, build_round_step

    cfg = get_config("qwen3-moe-235b-a22b").reduced(vocab=128)
    assert cfg.round_mode == "cohort_sequential" and cfg.n_experts
    rs = RoundSpec(cohort=2, local_steps=1, local_batch=2)
    assert callable(build_round_step(cfg, rs, shard=ShardSpec(axes=(("data", 2), ("model", 1)))))
    assert callable(build_round_step(cfg, rs, shard=ShardSpec()))
    for name in ("zoo_qwen3_sequential", "zoo_arctic_sequential"):
        assert get_config(CASES[name]["task"]["name"]).round_mode == "cohort_sequential"
