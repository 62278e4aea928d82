"""Paper Figure 4: three unbalance levels (v1/v2/v3) on an image-classifier
federated task.

    python -m repro_torch.examples.femnist_style [--out results/torch/femnist.json]

Port of ``examples/femnist_style.py``.  The paper's FEMNIST splits are
reproduced in shape: synthetic 14x14-style feature vectors with Dirichlet
label skew and power-law sizes tuned so the top 10%/20%/50% of clients hold
~82%/90%/98% of the data (v1/v2/v3); the model is an MLP stand-in for the
McMahan CNN.  ``make_vision_like`` is the reference's numpy generator, so
its arrays are the reference's bit for bit; it registers itself as the
``"vision_like"`` dataset (``api.register_dataset``), and each (level,
sampler) cell is an ordinary ``ExperimentSpec`` (``spec_for``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.data import FederatedDataset, power_law_sizes, size_share
from repro_torch.device import resolve_device
from repro_torch.examples._common import RESULTS, add_device_flag, eval_batch, write_json

# (n_clients, power-law alpha) per unbalance level; alpha tuned to the
# paper's share statistics at these client counts.
LEVELS = {
    "v1": dict(n_clients=200, alpha=2.8, share_frac=0.1),
    "v2": dict(n_clients=120, alpha=2.2, share_frac=0.2),
    "v3": dict(n_clients=60, alpha=1.2, share_frac=0.5),
}
DIM, N_CLASSES = 196, 20  # 14x14 synthetic "characters"


def make_vision_like(n_clients: int, alpha: float, seed: int) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    total = 120 * n_clients
    sizes = power_law_sizes(n_clients, total, alpha=alpha, seed=seed)
    s_max = int(sizes.max())
    # class prototypes + client-specific style shift (heterogeneity)
    protos = rng.normal(0, 1, size=(N_CLASSES, DIM))
    feats = np.zeros((n_clients, s_max, DIM), np.float32)
    labels = np.zeros((n_clients, s_max), np.int32)
    for i in range(n_clients):
        style = rng.normal(0, 0.6, size=(DIM,))
        # per-client label distribution (Dirichlet skew)
        pcls = rng.dirichlet(np.full(N_CLASSES, 0.5))
        y = rng.choice(N_CLASSES, p=pcls, size=int(sizes[i]))
        x = protos[y] + style[None] + rng.normal(0, 1.6, size=(int(sizes[i]), DIM))
        feats[i, : sizes[i]] = x
        labels[i, : sizes[i]] = y
        feats[i, sizes[i]:] = feats[i, 0]
        labels[i, sizes[i]:] = labels[i, 0]
    return FederatedDataset(
        torch.from_numpy(feats), torch.from_numpy(labels), torch.from_numpy(sizes.astype(np.int64))
    )


api.register_dataset("vision_like", make_vision_like)


def rounds_to_accuracy(acc_curve, eval_every, target):
    for i, a in enumerate(acc_curve):
        if a >= target:
            return i * eval_every
    return None


def budget_of(level: str) -> int:
    return max(5, int(0.05 * LEVELS[level]["n_clients"]))


def spec_for(args, level: str, name: str) -> api.ExperimentSpec:
    level_cfg = LEVELS[level]
    return api.ExperimentSpec(
        task=api.TaskSpec(
            name="mlp",
            kwargs=dict(dim=DIM, n_classes=N_CLASSES, hidden=128, depth=2),
            dataset="vision_like",
            dataset_kwargs=dict(
                n_clients=level_cfg["n_clients"],
                alpha=level_cfg["alpha"], seed=0,
            ),
        ),
        sampler=api.SamplerSpec(
            name=name,
            kwargs={"horizon": args.rounds} if name in ("kvib", "vrb") else {},
        ),
        federation=api.FederationSpec(
            rounds=args.rounds, budget=budget_of(level), local_steps=3,
            batch_size=20, local_lr=0.02, eval_every=5,
        ),
        execution=api.ExecutionSpec(seed=0),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=250)
    ap.add_argument("--samplers", nargs="+", default=["uniform_isp", "mabs", "vrb", "avare", "kvib"])
    ap.add_argument("--target-acc", type=float, default=0.60)
    ap.add_argument("--out", default=f"{RESULTS}/femnist.json")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    results = {"config": vars(args), "levels": {}}
    for level, level_cfg in LEVELS.items():
        budget = budget_of(level)
        first = api.build(spec_for(args, level, args.samplers[0]), dev)
        ds = first.dataset
        share = size_share(ds.sizes.cpu().numpy(), level_cfg["share_frac"])
        print(f"--- {level}: N={level_cfg['n_clients']} "
              f"top-{int(level_cfg['share_frac']*100)}% hold {share:.0%}, K={budget}")
        ev = eval_batch(ds, 7, 8)
        lv = {"share": share, "budget": budget, "samplers": {}}
        for name in args.samplers:
            spec = spec_for(args, level, name)
            built = first if name == args.samplers[0] else api.build(spec, dev)
            hist = api.run(spec, dev, eval_data=ev, built=built)
            tta = rounds_to_accuracy(
                hist.test_accuracy, spec.federation.eval_every, args.target_acc
            )
            lv["samplers"][name] = {
                "loss": [float(x) for x in hist.train_loss],
                "acc": [float(x) for x in hist.test_accuracy],
                "sq_error": [float(x) for x in hist.estimator_sq_error],
                "regret": [float(x) for x in hist.regret.dynamic_regret()],
                "rounds_to_target": tta,
                "wall_s": hist.wall_time_s,
            }
            print(
                f"  {name:<12} acc={hist.test_accuracy[-1]:.3f} "
                f"loss={hist.train_loss[-1]:.4f} "
                f"err={np.mean(hist.estimator_sq_error[args.rounds//3:]):.5f} "
                f"t@{args.target_acc:.0%}={tta}"
            )
        results["levels"][level] = lv
    write_json(args.out, results)
    return results


if __name__ == "__main__":
    main()
