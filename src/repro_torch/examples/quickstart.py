"""Quickstart: federated logistic regression with the K-Vib sampler.

    python -m repro_torch.examples.quickstart [--device cpu]

Port of ``examples/quickstart.py``: the paper's Section 6.1 synthetic task
for 100 rounds with budget K = 10% of clients, K-Vib against uniform ISP
sampling, printing the convergence and variance summary.  Each run is one
``repro_torch.api.ExperimentSpec``; the summaries also go to
``results/torch/quickstart.json``.
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.examples._common import RESULTS, add_device_flag, eval_batch, write_json

SAMPLERS = ("uniform_isp", "kvib")


def spec_for(args, sampler: str) -> api.ExperimentSpec:
    return api.ExperimentSpec(
        task=api.TaskSpec(
            name="logreg",
            dataset="synthetic_classification",
            dataset_kwargs=dict(
                n_clients=args.clients, total=200 * args.clients,
                power=2.0, seed=args.seed,
            ),
        ),
        sampler=api.SamplerSpec(
            name=sampler,
            kwargs={"horizon": args.rounds} if sampler == "kvib" else {},
        ),
        federation=api.FederationSpec(
            rounds=args.rounds, budget=args.budget, local_steps=2,
            batch_size=64, local_lr=0.02,
        ),
        execution=api.ExecutionSpec(
            seed=args.seed, compiled=not args.python_loop,
        ),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--budget", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--python-loop",
        action="store_true",
        help="per-round host copies of the metrics instead of the device-resident loop",
    )
    ap.add_argument("--out", default=f"{RESULTS}/quickstart.json")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    results = {"config": vars(args), "summary": {}}
    print(f"{'sampler':<14} {'loss':>8} {'acc':>7} {'est.err':>10} {'regret/T':>10} {'s':>6}")
    for name in SAMPLERS:
        spec = spec_for(args, name)
        built = api.build(spec, dev)
        ev = eval_batch(built.dataset, 999, 8)
        hist = api.run(spec, dev, eval_data=ev, built=built)
        s = hist.summary()
        results["summary"][name] = s
        print(
            f"{name:<14} {s['final_loss']:>8.4f} {s['final_acc']:>7.3f} "
            f"{s['mean_sq_error']:>10.5f} {s['final_dynamic_regret_per_round']:>10.4f} "
            f"{s['wall_time_s']:>6.1f}"
        )
    write_json(args.out, results)
    return results


if __name__ == "__main__":
    main()
