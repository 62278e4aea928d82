"""Paper Figure 5 (scaled): federated language-model training with client
samplers, the Section 6.3 experiment at simulation scale.

    python -m repro_torch.examples.fed_lm [--device cpu] [--model zoo --archs smollm ssm]

Port of ``examples/fed_lm.py``.  Clients hold heterogeneous token streams
(heavy long-tail sizes, distinct unigram styles); the model is a causal
LM.  ``--model tiny`` runs the built-in ``tiny_lm`` task; ``--model zoo``
fans each sampler out over reduced architecture-zoo configs, registered as
tasks (``api.register_task``) so they are names in the spec like any other:
the dense ``smollm`` and the Mamba2 hybrid ``ssm`` run, the ``moe`` and
``xlstm`` families are not ported yet.  The JSON goes to
``results/torch/fed_lm.json``; ``python -m repro_torch.bench.tables``
prints its fig5 rows.
"""
from __future__ import annotations

import argparse
import itertools

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
NOT_PORTED = ("moe", "xlstm")


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
        help="the closed train-to-serve loop (not ported yet: raises)",
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
        raise NotImplementedError(
            "fed_lm --serve (the train-to-serve loop) is not ported to repro_torch yet; "
            "see ROADMAP.md section 1, item 4, 'The serving loop'"
        )
    if args.model == "zoo" and any(a in NOT_PORTED for a in args.archs):
        raise NotImplementedError(
            f"--archs {sorted(a for a in args.archs if a in NOT_PORTED)}: the moe and xlstm "
            "families are not ported to repro_torch yet; see ROADMAP.md section 1, item 5, "
            "'The moe, xlstm, vlm and audio families' (pass --archs smollm ssm)"
        )
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
