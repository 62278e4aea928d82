"""Paper Figure 3(b) + Appendix Figure 6: regret vs communication budget K.

    python -m repro_torch.examples.budget_sweep [--out results/torch/budget.json]

Port of ``examples/budget_sweep.py``.  Theorem 5.2 predicts K-Vib's regret
shrinks as K^{-4/3} while the RSP baselines' bounds do not improve with K.
The grid is (sampler x budget), one ``ExperimentSpec`` per cell
(``make_spec``), differing only in ``federation.budget``.
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.examples._common import RESULTS, add_device_flag, write_json


def make_spec(args, name: str, k: int) -> api.ExperimentSpec:
    return api.ExperimentSpec(
        task=api.TaskSpec(
            name="logreg",
            dataset="synthetic_classification",
            dataset_kwargs=dict(
                n_clients=args.clients, total=200 * args.clients,
                power=2.0, seed=0,
            ),
        ),
        sampler=api.SamplerSpec(
            name=name,
            kwargs={"horizon": args.rounds} if name in ("kvib", "vrb") else {},
        ),
        federation=api.FederationSpec(
            rounds=args.rounds, budget=k, local_steps=1,
            batch_size=64, local_lr=0.02,
        ),
        execution=api.ExecutionSpec(seed=0, compiled=not args.python_loop),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--budgets", type=int, nargs="+", default=[5, 10, 20, 40])
    ap.add_argument("--samplers", nargs="+", default=["kvib", "vrb", "mabs", "avare"])
    ap.add_argument(
        "--python-loop",
        action="store_true",
        help="per-round host copies of the metrics instead of the device-resident loop",
    )
    ap.add_argument("--out", default=f"{RESULTS}/budget.json")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    results = {"config": vars(args), "regret_per_round": {}, "wall_s": {}}
    for name in args.samplers:
        for k in args.budgets:
            hist = api.run(make_spec(args, name, k), dev)
            rpt = float(hist.regret.dynamic_regret()[-1] / args.rounds)
            results["regret_per_round"].setdefault(name, {})[str(k)] = rpt
            results["wall_s"].setdefault(name, {})[str(k)] = hist.wall_time_s
            print(f"{name:<8} K={k:>3} regret/T = {rpt:.4f}")
    write_json(args.out, results)
    return results


if __name__ == "__main__":
    main()
