"""Host time a call of kernels 6-8's wrappers: this tree's against another
checkout's, in turns in one process on one GPU.

    python -m repro_torch.bench.host_ab OTHER

``OTHER`` is another checkout of the repo (the parent, unpacked with
``git archive``).  Its ``kernels/<name>.py`` is loaded beside this tree's
and calls the same built library, so only the Python on the call path
differs.  Each kernel runs at a shape small enough that the host, not the
card, sets the time of a call (kernel 6 at smollm-360m's decode rows).  For
16 pairs, the order swapped every round, each wrapper's time a call
is the best of 5 loops of 2,000 calls ended by one synchronize; the
median of the pairs' ratios is printed, which the host's drift between
rounds does not move (across processes the same number spreads about 2x).
The last line is a JSON object with each kernel's medians and ratio.

Use it for a change to a wrapper's Python that every launch passes
through (its checks, its dispatch); the card's time is the kernels
phase's of ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

__all__ = ["host_us", "load_other", "SHAPES", "main"]


def _rmsnorm_args(dev):
    return (torch.randn(8, 960, device=dev).bfloat16(),
            torch.zeros(960, dtype=torch.bfloat16, device=dev)), {}


def _flash_args(dev):
    q = torch.randn(1, 15, 64, 64, device=dev).bfloat16()
    k, v = (torch.randn(1, 5, 64, 64, device=dev).bfloat16() for _ in range(2))
    return (q, k, v), {"causal": True, "q_groups": 3}


def _ssd_args(dev):
    x = torch.randn(64, 64, 64, device=dev)
    da = -torch.rand(64, 64, device=dev)
    b, c = (torch.randn(1, 64, 64, device=dev) for _ in range(2))
    return (x, da, b, c), {"chunk": 64, "return_state": True}


# kernel -> (its arguments on a device, what the shape is)
SHAPES = {
    "rmsnorm": (_rmsnorm_args, "x (8, 960) bf16: smollm-360m's decode rows"),
    "flash_attention": (_flash_args, "q (1, 15, 64, 64), k and v (1, 5, 64, 64) bf16, causal"),
    "ssd_scan": (_ssd_args, "x (64, 64, 64) f32, b and c (1, 64, 64), chunk 64, with the state"),
}


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call in µs: the best of 5 loops of ``calls`` calls,
    each ended by one synchronize."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / calls)
    return best * 1e6


def load_other(other: Path, name: str):
    """``other``'s ``repro_torch/kernels/<name>.py`` as a module of its own
    (its imports resolve to this tree's package)."""
    spec = importlib.util.spec_from_file_location(
        f"other_{name}", other / "src" / "repro_torch" / "kernels" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ROUNDS = 16


def compare(name: str, other: Path, rounds: int = ROUNDS) -> dict:
    """Kernel ``name``'s host time a call through both wrappers, in turns."""
    ours = getattr(importlib.import_module(f"repro_torch.kernels.{name}"), name)
    theirs = getattr(load_other(other, name), name)
    args, kw = SHAPES[name][0](torch.device("cuda"))
    torch.testing.assert_close(theirs(*args, **kw), ours(*args, **kw), rtol=0, atol=0)
    times = {"this": [], "other": []}
    for i in range(rounds):
        pair = [("this", ours), ("other", theirs)]
        for key, fn in pair if i % 2 == 0 else pair[::-1]:
            times[key].append(host_us(lambda fn=fn: fn(*args, **kw)))
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    ratio = med([a / b for a, b in zip(times["this"], times["other"])])
    print(f"{name} host time a call, {SHAPES[name][1]}, in turns ({rounds} pairs): this tree "
          f"{med(times['this']):.2f} us (median; {', '.join(f'{t:.2f}' for t in times['this'])}), "
          f"{other} {med(times['other']):.2f} us "
          f"({', '.join(f'{t:.2f}' for t in times['other'])}): median ratio of the pairs "
          f"{ratio - 1:+.1%}", flush=True)
    return {"this_us": med(times["this"]), "other_us": med(times["other"]), "ratio": ratio}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="another checkout of the repo")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_ab: no CUDA GPU is visible", file=sys.stderr)
        return 2
    other = args.other.resolve()
    out = {name: compare(name, other) for name in SHAPES}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
