"""Roofline and dry-run tables from the dry run's records (the port of
``repro/analysis/report.py``).

  PYTHONPATH=src python -m repro_torch.analysis.report [--dir results/dryrun_torch]

The tables are the reference's, character for character, but for two
columns of the dry-run table: the mesh is the record's (``1xH100`` for one
card, the dry run's default; ``16x16`` or ``2x16x16`` for one chip of a
mesh) and the last column is the count's seconds (``trace s``), where the
reference's is XLA's compile seconds.  The roofline is ``analysis.roofline.HW``'s, the
datasheet peaks of one NVIDIA H100: predictions, not measurements.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.analysis.roofline import HW, roofline

__all__ = ["load_results", "roofline_table", "dryrun_table", "summarize", "perf_table", "main"]

MESH = "1xH100"


def load_results(ddir: str) -> list[dict]:
    out = []
    for f in sorted(os.listdir(ddir)):
        if f.endswith(".json"):
            with open(os.path.join(ddir, f)) as fh:
                out.append(json.load(fh))
    return out


def _fmt_seconds(x: float) -> str:
    if x >= 100:
        return f"{x:.0f}"
    if x >= 1:
        return f"{x:.2f}"
    return f"{x:.4f}"


def _fmt_bytes(x: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(x) < 1024 or unit == "TB":
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}TB"


def _terms(r: dict, hw: HW):
    return roofline(r["flops"], r["bytes_accessed"], r["collective_bytes"], r["n_chips"],
                    r["model_flops"], hw)


def roofline_table(results: list[dict], hw: HW = HW()) -> str:
    """One card's roofline, a row per counted step."""
    lines = [
        "| arch | shape | kind | compute s | memory s | collective s | dominant | "
        "flops/dev | HBM/dev | coll/dev | 6ND/HLO |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r.get("status") != "ok" or r.get("multi_pod"):
            continue
        t = _terms(r, hw)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {_fmt_seconds(t.compute_s)} | {_fmt_seconds(t.memory_s)} "
            f"| {_fmt_seconds(t.collective_s)} | **{t.dominant}** "
            f"| {r['flops']:.2e} | {_fmt_bytes(r['bytes_accessed'])} "
            f"| {_fmt_bytes(r['collective_bytes'])} | {t.useful_ratio:.3f} |"
        )
    return "\n".join(lines)


def dryrun_table(results: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | kind | mode | bytes/dev (args+tmp) | trace s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        mesh = r.get("mesh", MESH)
        if r.get("status") == "ok":
            mem = r["memory"]
            per_dev = mem["argument_size_bytes"] + mem["temp_size_bytes"]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | ok | {r['kind']} "
                f"| {r['round_mode'] if r['kind'] == 'train' else '-'} "
                f"| {_fmt_bytes(per_dev)} | {r['trace_s']} |"
            )
        else:
            reason = r.get("reason", r.get("status"))
            lines.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | {r['status']} | - | - | {reason} | - |"
            )
    return "\n".join(lines)


def summarize(results):
    ok = sum(1 for r in results if r.get("status") == "ok")
    skip = sum(1 for r in results if r.get("status") == "skip")
    bad = [r for r in results if r.get("status") not in ("ok", "skip")]
    return ok, skip, bad


def perf_table(perf_dir: str, hw: HW = HW()) -> str:
    """The perf variants' records (``launch.dryrun --opt``), one a file."""
    if not os.path.isdir(perf_dir):
        return f"(no {perf_dir} directory)"
    lines = [
        "| variant | opts | compute s | memory s | collective s | dominant |",
        "|---|---|---|---|---|---|",
    ]
    for f in sorted(os.listdir(perf_dir)):
        path = os.path.join(perf_dir, f)
        if not f.endswith(".json") or os.path.getsize(path) == 0:
            continue
        with open(path) as fh:
            r = json.load(fh)
        if r.get("status") != "ok":
            continue
        t = _terms(r, hw)
        lines.append(
            f"| {f[:-5]} | {','.join(r.get('opts', [])) or 'baseline'} "
            f"| {_fmt_seconds(t.compute_s)} | {_fmt_seconds(t.memory_s)} "
            f"| {_fmt_seconds(t.collective_s)} | **{t.dominant}** |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--perf-dir", default="results/perf_torch")
    args = ap.parse_args(argv)
    results = load_results(args.dir)
    ok, skip, bad = summarize(results)
    print(f"## Dry-run ({ok} ok, {skip} skip, {len(bad)} failed)\n")
    print(dryrun_table(results))
    print(f"\n## Roofline ({MESH}, per step; the datasheet peaks)\n")
    print(roofline_table(results))
    print("\n## Perf variants\n")
    print(perf_table(args.perf_dir))
    if bad:
        print("\nFAILED COMBOS:")
        for r in bad:
            print(" -", r["arch"], r["shape"], r.get("status"))


if __name__ == "__main__":
    main()
