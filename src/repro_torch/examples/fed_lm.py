"""Paper Figure 5 (scaled): federated language-model training with client
samplers, the Section 6.3 experiment at simulation scale.

    python -m repro_torch.examples.fed_lm [--device cpu] [--model zoo [--archs smollm moe ssm xlstm]]
    python -m repro_torch.examples.fed_lm --serve --rounds 6 --clients 8 --budget 3

Port of ``examples/fed_lm.py``.  Clients hold heterogeneous token streams
(heavy long-tail sizes, distinct unigram styles); the model is a causal
LM.  ``--model tiny`` runs the built-in ``tiny_lm`` task; ``--model zoo``
fans each sampler out over reduced architecture-zoo configs, registered as
tasks (``api.register_task``) so they are names in the spec like any other:
the dense ``smollm``, the top-k MoE ``moe`` (qwen3), the Mamba2 hybrid
``ssm`` and ``xlstm``, all four by default.  The JSON goes to
``results/torch/fed_lm.json``; ``python -m repro_torch.bench.tables``
prints its fig5 rows.  ``--serve`` runs the closed train-to-serve loop in
one process instead (``run_serve_demo``).
"""
from __future__ import annotations

import argparse
import itertools
import tempfile
import threading

import torch

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.examples._common import RESULTS, add_device_flag, write_json
from repro_torch.fed.tasks import Task

# --model zoo: one reduced config per architecture family, as in the
# reference (zamba2's 19-block pattern shortened so the reduced depth stays
# small; the pattern length must divide n_layers).
ZOO_ARCHS = {
    "smollm": ("smollm-360m", dict(n_layers=4, d_model=192, d_ff=512)),
    "moe": ("qwen3-moe-235b-a22b", {}),
    "ssm": (
        "zamba2-1.2b",
        dict(n_layers=4, block_pattern=("mamba2", "mamba2", "mamba2", "shared_attn")),
    ),
    "xlstm": ("xlstm-125m", {}),
}


def zoo_lm_task(vocab: int, arch: str = "smollm") -> Task:
    """A reduced zoo architecture wrapped as a federated Task."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    name, overrides = ZOO_ARCHS[arch]
    cfg = get_config(name).reduced(vocab=vocab, **overrides)

    def init(gen: torch.Generator, device):
        return transformer.init_params(cfg, gen, device)

    def loss(params, batch):
        return transformer.loss_fn(params, cfg, batch)

    def accuracy(params, batch):
        logits, _ = transformer.forward(params, cfg, batch[0])
        return (logits.argmax(-1) == batch[1]).to(torch.float32).mean()

    return Task(cfg.name, init, loss, accuracy)


api.register_task("zoo_reduced_lm", zoo_lm_task)
# The reference's alias: older result JSONs name the smollm-only task.
api.register_task("smollm_reduced_lm", lambda vocab: zoo_lm_task(vocab, "smollm"))


def variants(args) -> list:
    """(task name, task kwargs, arch) per model the run fans out over."""
    if args.model == "tiny":
        return [("tiny_lm", {}, None)]
    return [("zoo_reduced_lm", {"arch": a}, a) for a in args.archs]


def spec_for(args, sampler: str, task_name: str, task_kwargs: dict) -> api.ExperimentSpec:
    return api.ExperimentSpec(
        task=api.TaskSpec(
            name=task_name,
            kwargs=dict(vocab=args.vocab, **task_kwargs),
            dataset="synthetic_tokens",
            dataset_kwargs=dict(
                n_clients=args.clients, seq_len=args.seq, vocab=args.vocab,
                total_seqs=60 * args.clients, power=2.2, seed=0,
            ),
        ),
        sampler=api.SamplerSpec(
            name=sampler,
            kwargs={"horizon": args.rounds} if sampler in ("kvib", "vrb") else {},
        ),
        federation=api.FederationSpec(
            rounds=args.rounds, budget=args.budget, local_steps=1,
            batch_size=8, local_lr=0.3 if args.model == "tiny" else 0.1,
        ),
        execution=api.ExecutionSpec(seed=0),
    )


def serve_spec(args) -> api.ExperimentSpec:
    """The reference's ``--serve`` spec: the first of ``--archs`` reduced as
    a ``kind="zoo"`` run with the first of ``--samplers``, checkpointed
    every 2 rounds, served by a 2 x (16 + 48) engine gated on 2 batches."""
    arch_name, overrides = ZOO_ARCHS[args.archs[0]]
    sampler = args.samplers[0]
    return api.ExperimentSpec(
        task=api.TaskSpec(
            kind="zoo",
            name=arch_name,
            reduced=True,
            kwargs=dict(vocab=args.vocab, **overrides),
            dataset="synthetic_tokens",
            dataset_kwargs=dict(
                n_clients=args.clients, seq_len=args.seq, vocab=args.vocab,
                total_seqs=60 * args.clients, power=2.2, seed=0,
            ),
        ),
        sampler=api.SamplerSpec(
            name=sampler,
            kwargs={"horizon": args.rounds} if sampler in ("kvib", "vrb") else {},
        ),
        federation=api.FederationSpec(
            rounds=args.rounds, budget=args.budget, local_steps=1,
            batch_size=8, local_lr=0.1,
        ),
        execution=api.ExecutionSpec(seed=0, compiled=True, ckpt_every=2),
        serve=api.ServeSpec(batch=2, prompt_len=16, max_tokens=48, eval_batches=2),
    )


def run_serve_demo(args) -> dict:
    """The closed train-to-serve loop, one process: a zoo training run
    (``api.run`` with ``ckpt_manager`` and ``publish``) commits every
    checkpoint boundary from a daemon thread while the main thread serves
    traffic from the same directory (``launch.serve.follower``: watcher,
    promotion gate, hot swaps).

    The two sides share nothing but the checkpoint directory (and the spec
    that fingerprints it): the trainer could equally be another process
    (``launch.train`` + ``launch.serve --follow``).  They share the device
    and the interpreter; the serving side scores and decodes under
    ``torch.no_grad()`` (grad mode is per thread), and the kernels' launch
    counters count both sides.  Returns the summary and the pieces."""
    from repro_torch.checkpoint import CheckpointManager, config_fingerprint
    from repro_torch.launch.serve import follower, param_addresses

    spec = serve_spec(args)
    built = api.build(spec, resolve_device(args.device))

    with tempfile.TemporaryDirectory(prefix="fed_lm_serve_") as ckpt_dir:
        manager = CheckpointManager(ckpt_dir, fingerprint=config_fingerprint(spec.to_dict()))
        errors = []

        def publish(state, step):
            print(f"[train] committed boundary step {step}", flush=True)

        def train():
            try:
                api.run(spec, built.device, ckpt_manager=manager, built=built, publish=publish)
            except Exception as e:  # re-raised on the main thread
                errors.append(e)

        trainer = threading.Thread(target=train, daemon=True)
        session = follower(spec, built, manager)
        engine, gate = session.engine, session.gate

        def on_decision(cand, promoted):
            print(
                f"[serve] step {cand.step}: {'PROMOTE' if promoted else 'ROLLBACK'} "
                f"({gate.log.records[-1].reason})",
                flush=True,
            )

        session.on_decision = on_decision
        print(f"[serve] gate bar (round-0 init) = {gate.prime(engine.params):.4f}")
        ptrs = param_addresses(engine)
        trainer.start()
        summary = session.run(timeout=600.0)
        trainer.join()
    if errors:
        raise errors[0]
    assert param_addresses(engine) == ptrs, "engine parameters changed address under swaps"
    print(gate.log.render())
    print(summary.render(), flush=True)
    return {"summary": summary, "engine": engine, "gate": gate, "watcher": session.watcher,
            "spec": spec}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--budget", type=int, default=5)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--model", choices=["tiny", "zoo"], default="tiny")
    ap.add_argument(
        "--serve", action="store_true",
        help="run the closed train-to-serve loop instead of the sampler "
        "sweep: training (first of --samplers, first of --archs) publishes "
        "checkpoint boundaries while a serving engine hot-swaps the promoted "
        "ones (use a small --rounds, e.g. 6)",
    )
    ap.add_argument(
        "--archs", nargs="+", default=list(ZOO_ARCHS), choices=list(ZOO_ARCHS),
        help="zoo architecture families to run (only with --model zoo)",
    )
    ap.add_argument("--samplers", nargs="+", default=["uniform_isp", "vrb", "avare", "kvib"])
    ap.add_argument("--out", default=f"{RESULTS}/fed_lm.json")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.serve:
        return run_serve_demo(args)
    dev = resolve_device(args.device)
    results = {"config": vars(args), "runs": {}}
    # tiny runs one model; zoo fans each sampler out over the reduced
    # architecture families (result keys become "<sampler>/<arch>").
    for name, (task_name, task_kwargs, arch) in itertools.product(args.samplers, variants(args)):
        run_key = name if arch is None else f"{name}/{arch}"
        hist = api.run(spec_for(args, name, task_name, task_kwargs), dev)
        regret = hist.regret.dynamic_regret()
        results["runs"][run_key] = {
            "loss": [float(x) for x in hist.train_loss],
            "regret": [float(x) for x in regret],
            "sq_error": [float(x) for x in hist.estimator_sq_error],
            "wall_s": hist.wall_time_s,
        }
        print(
            f"{run_key:<18} loss {hist.train_loss[0]:.3f} -> {hist.train_loss[-1]:.3f}  "
            f"regret/T={regret[-1] / args.rounds:.4f} ({hist.wall_time_s:.0f}s)"
        )
    write_json(args.out, results)
    return results


if __name__ == "__main__":
    main()
