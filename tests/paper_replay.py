#!/usr/bin/env python3
"""The fig2 specs in both packages on the reference's draws, at full length.

    PYTHONPATH=src python tests/paper_replay.py [--rounds 300] [--seed 0] \
        [--samplers kvib uniform_isp ...]

Runs ``repro_torch.examples.synthetic_regret``'s spec for each sampler
through ``repro.api.run`` and through ``repro_torch.api.run(device="cpu")``
fed the reference's own draws (``test_torch_slice.jax_replay``), and prints
each package's regret/T and estimator variance (the fig2 row's numbers for
one seed), the largest per-round loss gap and whether every round's cohort
size agrees.  It separates what the port computes from what its random
streams draw: the two packages' tables differ by their draws, and this
script shows what the port gives on the reference's.  Not a pytest file
(minutes on the CPU).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro import api as ref_api  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.examples import synthetic_regret  # noqa: E402
from test_torch_slice import jax_replay  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samplers", nargs="+", default=synthetic_regret.SAMPLERS)
    cli = ap.parse_args(argv)
    args = synthetic_regret.parse_args(["--rounds", str(cli.rounds)])
    t = cli.rounds
    for name in cli.samplers:
        kw = {"horizon": t} if name in ("kvib", "vrb") else {}
        spec = synthetic_regret.make_spec(args, name, cli.seed, True, **kw)
        ref_spec = ref_api.ExperimentSpec.from_json(spec.to_json())
        built = ref_api.build(ref_spec)
        want = ref_api.run(ref_spec, built=built)
        got = api.run(spec, "cpu", random_source=jax_replay(built))
        gap = float(np.max(np.abs(np.asarray(got.train_loss) - np.asarray(want.train_loss))))
        print(
            f"{name:<12} regret/T reference {want.regret.dynamic_regret()[-1] / t:.6f} "
            f"port {got.regret.dynamic_regret()[-1] / t:.6f}; est.var reference "
            f"{np.mean(want.estimator_sq_error[t // 3:]):.6g} port "
            f"{np.mean(got.estimator_sq_error[t // 3:]):.6g}; max |loss gap| {gap:.3g}; "
            f"cohorts equal {got.cohort_size == want.cohort_size}",
            flush=True,
        )


if __name__ == "__main__":
    main()
