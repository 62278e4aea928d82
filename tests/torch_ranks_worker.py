"""Runs experiment specs on one rank of a client axis split over a gloo
group, for ``tests/test_torch_placement.py``.

``python tests/torch_ranks_worker.py RANK WORLD PORT CASES.json OUT_DIR``
joins a ``WORLD``-rank gloo group at ``tcp://127.0.0.1:PORT`` and runs each
case of the JSON list, writing ``OUT_DIR/<name>_r<RANK>.npz``.  The parent
test imports ``run_case`` and runs the same cases without a group (S = 1).

A case is a dict: ``name``; ``spec``, an ``ExperimentSpec`` dict; ``kind``,
one of ``run`` (``api.run``), ``interrupt`` (the compiled path stopped after
its first segment, saved to ``dir``), ``resume`` (``api.run`` resumed from
``dir``), ``layout`` (one segment; the resident shapes of the (N,) leaves);
``replay``, an optional pickled ``ReplaySource``; ``codes``, an npz of
compressed codes ``quantizer_codes`` recorded at S = 1, which the run is
handed in place of its own (with ``flips``: how many of its own codes
differ).  Imports no JAX.
"""
import contextlib
import datetime
import json
import os
import pickle
import sys

import numpy as np
import torch


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _history(hist) -> dict:
    out = {
        "loss": np.asarray(hist.train_loss, np.float64),
        "cohort": np.asarray(hist.cohort_size, np.int64),
        "dropped": np.asarray(hist.cohort_dropped, np.int64),
        "deadline_dropped": np.asarray(hist.deadline_dropped, np.int64),
        "sq_error": np.asarray(hist.estimator_sq_error, np.float64),
        "accuracy": np.asarray(hist.test_accuracy, np.float64),
    }
    if hist.regret is not None and hist.regret.costs:
        out["cost"] = np.asarray(hist.regret.costs, np.float64)
        out["opt_cost"] = np.asarray(hist.regret.opt_costs, np.float64)
        if hist.regret.score_history:
            out["scores"] = np.stack(hist.regret.score_history)
    out.update({f"param.{k}": v for k, v in _flat(hist.final_params).items()})
    return out


@contextlib.contextmanager
def quantizer_codes(path: str, record: bool):
    """Record every code and scale the run's quantizer writes to ``path``
    (``record``), or hand the run the ones recorded there, call for call:
    the estimator's rows of this rank's slots (a contiguous block,
    ``ShardSpec.local_range``) and the async ring's row whole.  The
    quantizer is patched where ``core/estimator.py`` and
    ``core/stragglers.py`` call it; nothing in the package changes.
    Yields a list that ends up holding, per call, the number of the run's
    own codes that differ from the ones handed to it."""
    from repro_torch.core import estimator, stragglers
    from repro_torch.launch.mesh import ShardSpec

    mods = (estimator, stragglers)
    real = {m: m.quantize_stacked for m in mods}
    flips: list = []
    got: dict = {}
    saved = None if record else np.load(path)

    def patched(mod):
        def quantize(flat, **kw):
            q, s = real[mod](flat, **kw)
            i = len(flips)
            if record:
                got[f"q{i}"], got[f"s{i}"] = q.numpy(), s.numpy()
                flips.append(0)
                return q, s
            rq, rs = torch.from_numpy(saved[f"q{i}"]), torch.from_numpy(saved[f"s{i}"])
            if rq.shape[0] != q.shape[0]:  # this rank's slots of the S = 1 cohort
                import torch.distributed as dist

                spec = ShardSpec(axes=(("data", dist.get_world_size()), ("model", 1)), axis="data")
                lo, hi = spec.local_range(rq.shape[0], dist.get_rank())
                rq, rs = rq[lo:hi], rs[lo:hi]
            flips.append(int((q != rq).sum()))
            return rq.clone(), rs.clone()
        return quantize

    for m in mods:
        m.quantize_stacked = patched(m)
    try:
        yield flips
    finally:
        for m in mods:
            m.quantize_stacked = real[m]
    if record:
        np.savez(path, **got)


def run_case(case: dict) -> dict:
    """One case on this process (a rank of the group, or alone at S = 1):
    name -> numpy array."""
    from repro_torch import api
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.fed.server import build_segment_runner
    from repro_torch.fed.state import run_segmented

    spec = api.ExperimentSpec.from_dict(case["spec"])
    source = None
    if case.get("replay"):
        with open(case["replay"], "rb") as f:
            source = pickle.load(f)
    kind = case.get("kind", "run")
    if kind == "run" and case.get("codes"):
        with quantizer_codes(case["codes"], case.get("record", False)) as flips:
            hist = api.run(spec, "cpu", random_source=source)
        return {**_history(hist), "flips": np.asarray(flips, np.int64)}
    if kind == "run":
        return _history(api.run(spec, "cpu", random_source=source))
    if kind == "resume":
        mgr = CheckpointManager(case["dir"])
        step = mgr.latest()
        hist = api.run(spec, "cpu", random_source=source, ckpt_manager=mgr)
        return {**_history(hist), "resumed_from": np.asarray(step)}
    built = api.build(spec, "cpu")
    cfg = built.fed_config
    segment, state = build_segment_runner(
        built.task, built.dataset, built.sampler, cfg, device="cpu", random_source=source
    )
    if kind == "interrupt":
        mgr = CheckpointManager(case["dir"], layout=built.sampler.shard)
        state = run_segmented(state, cfg.rounds, segment, ckpt_every=cfg.ckpt_every,
                              manager=mgr, max_segments=1)
        return {"round": np.asarray(state.round)}
    if kind == "layout":
        state = segment(state, 1)
        out = {f"sampler.{k}": np.asarray(getattr(state.sampler, k).shape)
               for k in ("stats", "aux")}
        out.update({f"metrics.{k}": np.asarray(v.shape) for k, v in state.metrics.items()})
        if isinstance(state.faults, dict) and "chain" in state.faults:
            out["faults.chain"] = np.asarray(state.faults["chain"].shape)
        return out
    raise ValueError(f"unknown case kind {kind!r}")


def main(argv) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh

    rank, world, port = int(argv[1]), int(argv[2]), int(argv[3])
    with open(argv[4]) as f:
        cases = json.load(f)
    out_dir = argv[5]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        for case in cases:
            mesh.reset_collective_counts()
            out = run_case(case)
            counts = mesh.collective_counts()
            out["collectives"] = np.asarray([counts[k] for k in sorted(counts)])
            np.savez(os.path.join(out_dir, f"{case['name']}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
