"""Paper Figure 2 + 3(c): dynamic regret, estimator variance and training
loss for all samplers on the synthetic logistic-regression task; optional
gamma-sensitivity sweep.

    python -m repro_torch.examples.synthetic_regret [--rounds 300] \
        [--gamma-sweep] [--out results/torch/synthetic.json]

Port of ``examples/synthetic_regret.py``: every (sampler, seed) cell is one
``ExperimentSpec`` (``make_spec``), run by ``repro_torch.api.run``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.examples._common import RESULTS, add_device_flag, eval_batch, write_json

SAMPLERS = ["uniform_rsp", "uniform_isp", "mabs", "vrb", "avare", "kvib"]


def make_spec(args, name, seed, compiled, **sampler_kw) -> api.ExperimentSpec:
    return api.ExperimentSpec(
        task=api.TaskSpec(
            name="logreg",
            dataset="synthetic_classification",
            dataset_kwargs=dict(
                n_clients=args.clients, total=200 * args.clients,
                power=2.0, seed=seed,
            ),
        ),
        sampler=api.SamplerSpec(name=name, kwargs=sampler_kw),
        federation=api.FederationSpec(
            rounds=args.rounds, budget=args.budget, local_steps=1,
            batch_size=64, local_lr=0.02,
        ),
        execution=api.ExecutionSpec(seed=seed, compiled=compiled),
    )


def run_one(spec, ev, device):
    hist = api.run(spec, device, eval_data=ev)
    return {
        "loss": [float(x) for x in hist.train_loss],
        "acc": [float(x) for x in hist.test_accuracy],
        "regret": [float(x) for x in hist.regret.dynamic_regret()],
        "sq_error": [float(x) for x in hist.estimator_sq_error],
        "cohort": [int(x) for x in hist.cohort_size],
        "wall_s": hist.wall_time_s,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--budget", type=int, default=10)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--gamma-sweep", action="store_true")
    ap.add_argument(
        "--python-loop",
        action="store_true",
        help="per-round host copies of the metrics instead of the device-resident loop",
    )
    ap.add_argument("--out", default=f"{RESULTS}/synthetic.json")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    compiled = not args.python_loop
    results = {"config": vars(args), "runs": {}}
    for seed in range(args.seeds):
        ev = None
        for name in SAMPLERS:
            kw = {"horizon": args.rounds} if name in ("kvib", "vrb") else {}
            spec = make_spec(args, name, seed, compiled, **kw)
            if ev is None:
                ev = eval_batch(api.build(spec, dev).dataset, 999, 8)
            r = run_one(spec, ev, dev)
            results["runs"].setdefault(name, []).append(r)
            print(
                f"seed {seed} {name:<12} regret/T={r['regret'][-1]/args.rounds:9.4f} "
                f"err={np.mean(r['sq_error'][args.rounds//3:]):9.5f} "
                f"loss={r['loss'][-1]:.4f} acc={r['acc'][-1]:.3f} ({r['wall_s']:.0f}s)"
            )

    if args.gamma_sweep:
        for gamma in (1e-4, 1e-3, 1e-2, 1e-1, 1.0):
            spec = make_spec(args, "kvib", 0, compiled, horizon=args.rounds, gamma=gamma)
            hist = api.run(spec, dev)
            reg = float(hist.regret.dynamic_regret()[-1])
            err = float(np.mean(hist.estimator_sq_error))
            results["runs"].setdefault("kvib_gamma", []).append(
                {"gamma": gamma, "regret": reg, "sq_error": err}
            )
            print(f"gamma={gamma:g} regret={reg:.2f} err={err:.5f}")

    write_json(args.out, results)
    return results


if __name__ == "__main__":
    main()
