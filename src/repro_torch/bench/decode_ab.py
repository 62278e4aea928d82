"""Host time of a decode step: this tree's against another checkout's, in
turns in one process on one GPU.

    python -m repro_torch.bench.decode_ab OTHER

``OTHER`` is another checkout of the repo (the parent, unpacked with
``git archive``).  Its ``repro_torch`` package is imported beside this
tree's as a second set of modules, and ``sys.modules`` holds the set that
runs while it runs, so the lazy imports inside each tree resolve to its own
modules; each tree builds its kernels under its own ``kernels/build``.
Both step smollm-360m at full width in bf16, batch 8, after a prompt of 512
tokens ((k)'s serving shape in ``chip_smoke.py``), on the same random
weights, no mesh.  A decode step is host dispatch (about 1,650 launches),
so the time of a loop of steps ended by one synchronize is the host's.
For ``ROUNDS`` pairs, the order swapped every round, each tree's time a step
is the best of 3 loops of 30 steps; the median of the pairs' ratios is
printed.  The first step's logits of the two trees must be bitwise equal.
The last line is a JSON object with the medians and the ratio.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

__all__ = ["load_tree", "main"]

ROUNDS = 10
ARCH, BATCH, PROMPT, STEPS, LOOPS = "smollm-360m", 8, 512, 30, 3


def _ours() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == "repro_torch" or k.startswith("repro_torch.")}


def _activate(mods: dict) -> None:
    for k in list(_ours()):
        del sys.modules[k]
    sys.modules.update(mods)


def load_tree(src: Path) -> dict:
    """``src``'s ``repro_torch`` modules (``configs``, ``models.transformer``
    and what they import), loaded beside the ones in ``sys.modules``, which
    are left as they were."""
    mine = _ours()
    _activate({})
    sys.path.insert(0, str(src))
    try:
        import repro_torch.configs  # noqa: F401
        import repro_torch.models.transformer  # noqa: F401
        theirs = _ours()
    finally:
        sys.path.remove(str(src))
        _activate(mine)
    return theirs


def _setup(mods: dict, params, tokens):
    """A decode step of the tree ``mods`` at index ``PROMPT``, after its
    own prefill: (step, first logits)."""
    _activate(mods)
    cfg = mods["repro_torch.configs"].get_config(ARCH)
    tf = mods["repro_torch.models.transformer"]
    _, caches = tf.prefill(params, cfg, tokens, max_seq=PROMPT + 1)
    token = tokens[:, -1:]

    def step():
        return tf.decode_step(params, cfg, token, caches, PROMPT)[0]

    return step, step()


def _per_step(step) -> float:
    best = float("inf")
    for _ in range(LOOPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / STEPS)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="another checkout of the repo")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.configs  # noqa: F401  (this tree's set)
    import repro_torch.models.transformer  # noqa: F401

    trees = {"this": _ours(), "other": load_tree(args.other.resolve() / "src")}
    with torch.no_grad():
        cfg = trees["this"]["repro_torch.configs"].get_config(ARCH)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = trees["this"]["repro_torch.models.transformer"].init_params(cfg, gen, "cuda")
        tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device="cuda", generator=gen)
        steps, first = {}, {}
        for key, mods in trees.items():
            steps[key], first[key] = _setup(mods, params, tokens)
        if not torch.equal(first["this"], first["other"]):
            print("decode_ab: the two trees' logits differ", file=sys.stderr)
            return 1
        times = {"this": [], "other": []}
        for i in range(args.rounds):
            order = ("this", "other") if i % 2 == 0 else ("other", "this")
            for key in order:
                _activate(trees[key])
                for _ in range(3):  # warm
                    steps[key]()
                times[key].append(_per_step(steps[key]))
    _activate(trees["this"])

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    ratio = med([a / b for a, b in zip(times["this"], times["other"])])
    out = {key: med(ts) * 1e3 for key, ts in times.items()}
    print(f"decode step host time, {ARCH} bf16 batch {BATCH} at index {PROMPT}, in turns "
          f"({args.rounds} pairs, best of {LOOPS} loops of {STEPS} steps): this tree "
          f"{out['this']:.3f} ms (median; {', '.join(f'{t * 1e3:.3f}' for t in times['this'])}), "
          f"{args.other} {out['other']:.3f} ms "
          f"({', '.join(f'{t * 1e3:.3f}' for t in times['other'])}): median ratio of the pairs "
          f"{ratio:.4f}; first logits bitwise equal", flush=True)
    print(json.dumps({"this_ms": out["this"], "other_ms": out["other"], "ratio": ratio}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
