"""Paper figures from the port's experiment artifacts.

    python -m repro_torch.bench.tables [--results-dir results/torch]

Port of ``benchmarks/run.py``'s ``table_synthetic`` (fig2),
``table_budget`` (fig3b), ``table_femnist`` (fig4) and ``table_fed_lm``
(fig5): the same ``name,us_per_call,derived`` CSV rows, with the same row
names and formats, read from the JSON of
``repro_torch.examples.synthetic_regret``, ``budget_sweep``,
``femnist_style`` and ``fed_lm``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = [
    "row", "table_synthetic", "table_budget", "table_femnist", "table_fed_lm", "TABLES", "main",
]

RESULTS = os.path.join("results", "torch")


def row(name: str, us: float, derived: str = "") -> tuple:
    print(f"{name},{us:.2f},{derived}", flush=True)
    return name, us, derived


def _load(results_dir: str, fname: str):
    path = os.path.join(results_dir, fname)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def table_synthetic(results_dir: str = RESULTS) -> list:
    data = _load(results_dir, "synthetic.json")
    if data is None:
        return [row("fig2_synthetic", 0, "MISSING - run python -m repro_torch.examples.synthetic_regret")]
    t = data["config"]["rounds"]
    rows = []
    for name, runs in data["runs"].items():
        if name == "kvib_gamma":
            continue
        reg = np.mean([r["regret"][-1] / t for r in runs])
        err = np.mean([np.mean(r["sq_error"][t // 3:]) for r in runs])
        rows.append(row(f"fig2_regretT_{name}", 0, f"dynamic regret/T={reg:.5f} est.var={err:.6f}"))
    return rows


def table_budget(results_dir: str = RESULTS) -> list:
    data = _load(results_dir, "budget.json")
    if data is None:
        return [row("fig3b_budget", 0, "MISSING - run python -m repro_torch.examples.budget_sweep")]
    rows = []
    for name, by_k in data["regret_per_round"].items():
        ks = sorted(by_k, key=int)
        speedup = by_k[ks[0]] / max(by_k[ks[-1]], 1e-9)
        rows.append(row(
            f"fig3b_{name}",
            0,
            f"regret/T K={ks[0]}:{by_k[ks[0]]:.4f} -> K={ks[-1]}:{by_k[ks[-1]]:.4f} ({speedup:.0f}x)",
        ))
    return rows


def table_femnist(results_dir: str = RESULTS) -> list:
    data = _load(results_dir, "femnist.json")
    if data is None:
        return [row("fig4_femnist", 0, "MISSING - run python -m repro_torch.examples.femnist_style")]
    rows = []
    for level, lv in data["levels"].items():
        for name, run in lv["samplers"].items():
            tta = run.get("rounds_to_target")
            rows.append(row(
                f"fig4_{level}_{name}",
                0,
                f"acc={run['acc'][-1]:.3f} t@target={tta} est.var={np.mean(run['sq_error']):.5f}",
            ))
    return rows


def table_fed_lm(results_dir: str = RESULTS) -> list:
    data = _load(results_dir, "fed_lm.json")
    if data is None:
        return [row("fig5_fed_lm", 0, "MISSING - run python -m repro_torch.examples.fed_lm")]
    return [
        row(f"fig5_lm_{name}", 0, f"loss {run['loss'][0]:.3f}->{run['loss'][-1]:.3f}")
        for name, run in data["runs"].items()
    ]


TABLES = {
    "fig2": table_synthetic, "fig3b": table_budget, "fig4": table_femnist, "fig5": table_fed_lm,
}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", default=RESULTS)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return [r for table in TABLES.values() for r in table(args.results_dir)]


if __name__ == "__main__":
    main()
