"""Federated training launcher: any ported zoo architecture x any sampler
(the port of ``repro/launch/train.py``).

The run is an ``repro_torch.api.ExperimentSpec``; the flags below are a
thin shim parsed INTO one (``build_spec_from_args``), and the spec is what
runs::

  # flags -> spec -> run (on the GPU; --device cpu for the plain path)
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \\
      --rounds 8 --clients 32 --budget 6 --sampler kvib --seq 64 --ckpt /tmp/fl

  # print the spec a flag set denotes (no training), then run it verbatim
  PYTHONPATH=src python -m repro_torch.launch.train [flags...] --dump-spec > exp.json
  PYTHONPATH=src python -m repro_torch.launch.train --spec exp.json

``--spec`` consumes exactly what ``--dump-spec`` emits and reproduces the
flag-driven run's final parameters bit for bit.  The JSON is the
reference's, so ``repro.launch.train --dump-spec`` and this one print the
same spec, and ``checkpoint.config_fingerprint`` of it is the same 16 hex
digits in both packages.  The manifest's fingerprint derives from
``spec.to_dict()``: any changed spec field refuses to resume an old run.

Two modes, on the same random source (``rng.PhiloxSource`` seeded from
``--seed``, drawn from in the same order, so they train on the same draws
and batches):

* default (host loop): one round at a time, ``fed.round.build_round_step``
  on cohort batches gathered by ``fed.cohort.host_gather_cohort_batches``;
  fault injection and delta compression need the carried state and are
  refused;
* ``--compiled``: the run is segments of rounds over a ``TrainState``
  (``fed.round.build_fed_scan_segment`` driven by
  ``fed.state.run_segmented``), the construction ``api.run`` uses, on one
  device, or over ranks: ``python -m torch.distributed.run
  --nproc-per-node S -m repro_torch.launch.train ... --compiled`` with
  ``REPRO_MESH_SHAPE=S,1`` splits the client axis over S gloo ranks;
  without it the host mesh gives the model axis the largest of 16, 8, 4,
  2, 1 dividing S (two ranks: (1, 2)), whose ranks replicate the run and
  only rank 0 writes.
  ``--ckpt-every N`` cuts the horizon into N-round segments (bitwise
  neutral) and, with ``--ckpt DIR``, publishes the whole
  ``TrainState`` through a ``CheckpointManager`` in ``DIR_ckpts/`` at every
  boundary, with ``spec.json`` written beside the manifest before round 0
  (what ``launch.serve --follow`` reads); ``--resume`` restarts a killed
  run from the manifest and reproduces the uninterrupted run exactly.
  ``--resume`` without the compiled path is an error: host-loop snapshots
  hold parameters and sampler state only.

``REPRO_KILL_AFTER_SEGMENTS=N`` (environment) SIGKILLs the process after N
published segments: the reference's hook for a preemption test.
``--lint`` runs ``repro_torch.analysis.lint.run_suite`` on the built spec
before training (on the CPU, over fake tensors: no weights are made), prints
the report and exits 1 on a finding, as the reference's launcher does.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import torch
import torch.distributed as dist

from repro_torch.api import (
    CompressionSpec,
    ExecutionSpec,
    ExperimentSpec,
    FaultSpec,
    FederationSpec,
    SamplerSpec,
    TaskSpec,
    build,
)
from repro_torch.api.runner import _make_mesh, _zoo_segment_and_state
from repro_torch.checkpoint import CheckpointManager, config_fingerprint, save_checkpoint
from repro_torch.core import estimator
from repro_torch.core.samplers import draw_input, sampler_names
from repro_torch.fed.cohort import host_gather_cohort_batches, scatter_cohort, select_cohort
from repro_torch.fed.round import ZooModel, build_round_step
from repro_torch.fed.state import run_segmented
from repro_torch.launch.mesh import is_writer
from repro_torch.models import transformer
from repro_torch.rng import PhiloxSource


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Federated training of a zoo arch; flags are a shim over "
        "repro_torch.api.ExperimentSpec (--dump-spec shows the spec they denote)"
    )
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--sampler", default="kvib", choices=sampler_names())
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--budget", type=int, default=6)
    ap.add_argument("--cohort", type=int, default=8, help="padded cohort buffer C")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument(
        "--ckpt-every", type=int, default=0,
        help="checkpoint every N rounds; with --compiled this is the segment "
        "length (bitwise neutral) and checkpoints go to the <ckpt>_ckpts/ "
        "CheckpointManager directory.  WITHOUT --compiled the host loop saves "
        "params+sampler snapshots only, which are NOT resumable",
    )
    ap.add_argument(
        "--compiled", action="store_true",
        help="run the rounds as segments over a TrainState "
        "(fed.round.build_fed_scan_segment), as api.run does; default is the "
        "per-round host loop",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="with --compiled --ckpt --ckpt-every: resume from the newest "
        "committed step in <ckpt>_ckpts/manifest.json (fresh start if none). "
        "Errors without the compiled path: host-loop checkpoints are not "
        "resumable",
    )
    ap.add_argument(
        "--shard-sampler", default="", metavar="AXIS",
        help="the mesh axis the sampler's client axis is split over "
        "(ExecutionSpec.sampler_axis, e.g. 'data'): K-Vib's solve runs the "
        "sharded solve, split when the axis holds several ranks",
    )
    ap.add_argument(
        "--faults", default="", metavar="JSON",
        help="deployment-realism fault layer as a FaultSpec JSON object, "
        "e.g. '{\"availability\": \"markov\", \"availability_kwargs\": "
        "{\"p_on\": 0.7, \"p_off\": 0.2}, \"deadline\": 1.0}': availability "
        "processes, deadline stragglers (unbiased reweighting) and "
        "buffered-async aggregation.  Requires --compiled (the fault state "
        "lives in the TrainState carry)",
    )
    ap.add_argument(
        "--delta-dtype", default="", choices=["", "int8", "fp8"],
        help="quantize client deltas to this width inside the round "
        "(CompressionSpec.delta_dtype; kernel 4 aggregates them) with a "
        "server-side error-feedback residual.  Requires --compiled (the "
        "residual lives in the TrainState carry)",
    )
    ap.add_argument(
        "--no-error-feedback", action="store_true",
        help="with --delta-dtype: drop the error-feedback residual",
    )
    ap.add_argument(
        "--spec", default="",
        help="load the experiment from an ExperimentSpec JSON file (as "
        "emitted by --dump-spec); the experiment flags above are ignored",
    )
    ap.add_argument(
        "--dump-spec", action="store_true",
        help="print the ExperimentSpec JSON these flags denote and exit "
        "without training",
    )
    ap.add_argument(
        "--lint", action="store_true",
        help="statically lint the spec before training (repro_torch.analysis.lint: "
        "width / scan-safety / dtype; exit 1 on a finding)",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; not part of the spec")
    return ap


def build_spec_from_args(args) -> ExperimentSpec:
    """The flags -> spec projection: the one place CLI flags acquire meaning.

    ``--spec`` / ``--dump-spec`` / ``--ckpt`` / ``--resume`` / ``--device``
    say where to run or persist the experiment, not what it is, and do not
    appear in the spec."""
    return ExperimentSpec(
        task=TaskSpec(
            kind="zoo",
            name=args.arch,
            reduced=args.reduced,
            dataset="synthetic_tokens",
            dataset_kwargs={"n_clients": args.clients, "seq_len": args.seq},
        ),
        sampler=SamplerSpec(
            name=args.sampler,
            kwargs=({"horizon": args.rounds} if args.sampler in ("kvib", "vrb") else {}),
        ),
        federation=FederationSpec(
            rounds=args.rounds,
            budget=args.budget,
            cohort=args.cohort,
            local_steps=args.local_steps,
            batch_size=args.local_batch,
            local_lr=args.local_lr,
        ),
        execution=ExecutionSpec(
            seed=args.seed,
            compiled=args.compiled,
            ckpt_every=args.ckpt_every,
            sampler_axis=args.shard_sampler or None,
        ),
        fault=(FaultSpec(**json.loads(args.faults)) if args.faults else FaultSpec()),
        compression=CompressionSpec(
            delta_dtype=args.delta_dtype or None,
            error_feedback=not args.no_error_feedback,
        ),
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_line(dev: torch.device) -> str:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the plain PyTorch path"
    return f"compiled segments on one device: {dev} ({name})"


def draw_cohort(sampler, s_state, source, t: int, lam, cohort: int):
    """Round t's draw mapped onto ``cohort`` slots, as the compiled round
    body draws it from the same streams (the probabilities solved once, the
    draw, the estimator's weights, the cohort priorities): (selection,
    draw, probabilities)."""
    n = lam.shape[0]
    p = sampler.probabilities(s_state)
    draw = sampler.sample_from(p, draw_input(source, sampler.procedure, t, n, sampler.budget))
    w_full = estimator.client_weights(draw, lam, sampler.procedure, sampler.budget)
    return select_cohort(draw.mask, w_full, cohort, source.cohort_priorities(t, n)), draw, p


def run_spec(spec: ExperimentSpec, *, ckpt: str = "", resume: bool = False, device=None) -> dict:
    """Execute a zoo ExperimentSpec with launcher ergonomics (per-round
    prints, checkpoint publishing, the kill/resume hook).  The construction
    (arch config, dataset, sampler, ``RoundSpec``, random source) is
    ``repro_torch.api.build``'s and ``api.run``'s, so the compiled path
    trains the run ``api.run`` would.  Returns the final ``params`` and
    ``sampler`` state and the per-round ``losses`` and ``cohorts``."""
    built = build(spec, device)
    cfg, ds, sampler, dev = built.arch_config, built.dataset, built.sampler, built.device
    rspec = built.round_spec
    fed, ex = built.spec.federation, spec.execution
    rounds, ckpt_every = fed.rounds, ex.ckpt_every
    source = PhiloxSource(ex.seed, dev)

    writer = is_writer()  # rank 0 writes files; the other ranks replicate or split its work
    if sampler.splits and not ex.compiled:
        raise ValueError(
            f"the client axis is split over {sampler.shard.num_shards} ranks: the host loop "
            "runs one rank alone; pass --compiled"
        )
    if ex.compiled:
        # The weights are the source's first draw, as in api.run.
        segment, state = _zoo_segment_and_state(built, source)
        params = state.params
    else:
        params = source.init_params(ZooModel(cfg))
    n_params = transformer.param_count(params)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M clients={ds.n_clients} "
          f"K={fed.budget} cohort={rspec.cohort} sampler={spec.sampler.name}")

    if ex.compiled:
        # The reference's host mesh (execution.mesh_shape, REPRO_MESH_SHAPE,
        # else over the default process group's ranks).
        mesh = _make_mesh(spec)
        print(f"compiled scan on mesh {mesh.shape} ({mesh.size} ranks)")
        print(_device_line(dev))
        manager = None
        if resume and not (ckpt and ckpt_every):
            print("warning: --resume needs --ckpt AND --ckpt-every; starting fresh")
        if ckpt and ckpt_every:
            # The spec IS the run configuration: its canonical serialization
            # is what the manifest fingerprints, so resuming under any
            # changed spec field raises instead of mixing runs.
            manager = CheckpointManager(
                f"{ckpt}_ckpts", fingerprint=config_fingerprint(spec.to_dict())
            )
            # The spec goes next to the manifest BEFORE training: a server
            # following this directory (launch.serve --follow) rebuilds the
            # run configuration, and its fingerprint, from this file alone.
            os.makedirs(manager.directory, exist_ok=True)
            if writer:
                spec.save(os.path.join(manager.directory, "spec.json"))
            if resume:
                state, start = manager.restore_or_init(state)
                if start:
                    print(f"resumed from checkpoint step {start} "
                          f"({rounds - start} rounds remaining)")

        # Test hook: self-SIGKILL after N published segments, a preemption
        # that strikes between segment boundaries.
        kill_after = int(os.environ.get("REPRO_KILL_AFTER_SEGMENTS", "0"))
        segments_done = []

        def on_segment(st, rounds_done):
            segments_done.append(rounds_done)
            if manager is not None and writer:
                print(f"checkpoint step {rounds_done} -> {manager.directory}", flush=True)
            if kill_after and len(segments_done) >= kill_after:
                print(f"REPRO_KILL_AFTER_SEGMENTS={kill_after}: SIGKILL", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

        start_round = int(state.round)
        t0 = time.time()
        state = run_segmented(
            state, rounds, segment, ckpt_every=ckpt_every, manager=manager, on_segment=on_segment,
        )
        _sync(dev)
        wall = time.time() - t0
        if segment.layout is not None:  # every rank returns the whole sampler state
            state = segment.layout.gather(state, ("sampler",))
        params, s_state = state.params, state.sampler
        losses = state.metrics["loss"].cpu().numpy()
        cohorts = state.metrics["cohort_size"].cpu().numpy()
        for t in range(rounds):
            print(f"round {t:>3} loss={losses[t]:.4f} cohort={int(cohorts[t])}")
        n_disp = len(segments_done)
        disp = "one dispatch" if n_disp == 1 else f"{n_disp} dispatches"
        print(f"{rounds - start_round} rounds in {disp}: {wall:.1f}s "
              f"({wall / max(rounds - start_round, 1):.2f}s/round)", flush=True)
        dropped_total = int(state.metrics["dropped"].sum())
        if dropped_total:
            print(f"cohort overflow drops: {dropped_total}")
        if "deadline_dropped" in state.metrics:
            print(f"deadline straggler drops: {int(state.metrics['deadline_dropped'].sum())}")
        if ckpt and writer:
            f = save_checkpoint(ckpt, {"params": params, "sampler": s_state})
            print("final checkpoint ->", f)
        return {"params": params, "sampler": s_state, "losses": [float(x) for x in losses],
                "cohorts": [int(x) for x in cohorts]}

    if rspec.faults is not None:
        raise SystemExit(
            "fault injection (FaultSpec enabled) requires --compiled: the "
            "fault state (availability chain, stale-delta buffer) lives in "
            "the TrainState carry, which the per-round host loop does not thread"
        )
    if rspec.compression is not None:
        raise SystemExit(
            "delta compression (--delta-dtype) requires --compiled: the "
            "error-feedback residual lives in the TrainState carry, which the "
            "per-round host loop does not thread"
        )
    round_step = build_round_step(cfg, rspec)
    lam, n = ds.lam, ds.n_clients
    s_state = sampler.init(dev)
    losses, cohorts = [], []
    dropped_total = 0
    for t in range(rounds):
        t0 = time.time()
        # The compiled round body's draws, from the same streams: the cohort
        # (``draw_cohort``), then the round's (N, R, B) batch indices.
        sel, draw, p = draw_cohort(sampler, s_state, source, t, lam, rspec.cohort)
        dropped_total += int(sel.n_dropped)
        idx = source.batch_indices(t, ds.sizes, rspec.local_steps, rspec.local_batch)
        tokens, targets = host_gather_cohort_batches(
            ds, sel, idx[sel.ids], rspec.local_steps, rspec.local_batch
        )
        params, norms, loss = round_step(params, tokens.long(), targets.long(), sel.weights)
        # feedback: lambda_i ||g_i|| for the clients actually trained
        s_state = sampler.update(s_state, draw, scatter_cohort(lam[sel.ids] * norms, sel, n))
        losses.append(float(loss))
        cohorts.append(int(sel.valid.sum()))
        print(
            f"round {t:>3} loss={losses[-1]:.4f} cohort={cohorts[-1]} "
            f"p[min/max]={float(p.min()):.3f}/{float(p.max()):.3f} "
            f"({time.time() - t0:.1f}s)", flush=True,
        )
        if ckpt and ckpt_every and (t + 1) % ckpt_every == 0:
            # Host-loop snapshot: params+sampler ONLY (not resumable).
            f = save_checkpoint(f"{ckpt}_r{t + 1}", {"params": params, "sampler": s_state})
            print("  checkpoint ->", f)
    if dropped_total:
        print(f"cohort overflow drops: {dropped_total}")
    if ckpt:
        f = save_checkpoint(ckpt, {"params": params, "sampler": s_state})
        print("final checkpoint ->", f)
    return {"params": params, "sampler": s_state, "losses": losses, "cohorts": cohorts}


def main(argv=None):
    ap = make_parser()
    args = ap.parse_args(argv)

    spec = ExperimentSpec.load(args.spec) if args.spec else build_spec_from_args(args)

    if args.dump_spec:
        print(spec.to_json())
        return None

    if args.lint:
        from repro_torch.analysis.lint import run_suite

        report = run_suite(spec)
        print(report.render(), flush=True)
        if not report.ok:
            raise SystemExit(1)

    if args.resume and not spec.execution.compiled:
        ap.error(
            "--resume requires the compiled path (--compiled, or "
            '"execution": {"compiled": true} in --spec): host-loop '
            "checkpoints hold params+sampler only, no random-source state "
            "or round index, and cannot be resumed"
        )

    # Under ``python -m torch.distributed.run --nproc-per-node S`` each rank
    # joins the gloo group its environment names; REPRO_MESH_SHAPE=S,1 (or
    # the spec's mesh_shape) then splits the client axis over it, and the
    # ranks of a model axis replicate their data block.
    group = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if group:
        dist.init_process_group("gloo")
    try:
        return run_spec(spec, ckpt=args.ckpt, resume=args.resume, device=args.device)
    finally:
        if group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
