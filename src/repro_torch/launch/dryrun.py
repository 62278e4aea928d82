"""Dry run for one H100: count every (arch x input shape) step of the port
without running it (the port of ``repro/launch/dryrun.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k [--opt remat_none]
  python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch]  # a subprocess per combo

The reference lowers and compiles each step against a production mesh of
TPU chips and reads XLA's memory and cost analyses.  The port has one card
and no compiler: ``run_one`` builds the step from its setup (the federated
round step for ``train``, ``transformer.prefill``, ``transformer.decode_step``)
on ``meta`` parameters and inputs (``transformer.init_params(cfg, None,
"meta")``, ``configs.input_specs``: no weight is drawn) and counts one call
with ``analysis.cost.count``: the eager ops on ``meta`` tensors, kernels 6-8
charged as their kernels.  CUDA is never initialised and no card is needed.
``trace_s`` (the count's seconds) takes the place of ``lower_s`` and
``compile_s``; there is no ``raw_cost_analysis``.  ``analysis.report``
prints the records as the reference's tables.

Like the reference's, the dry run sits below the spec layer: it sweeps raw
(arch, shape) combinations and never builds a dataset or sampler.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch.analysis.cost import count
from repro_torch.analysis.roofline import active_params, model_flops
from repro_torch.configs import INPUT_SHAPES, get_config, input_specs, list_archs, step_kind
from repro_torch.fed.round import RoundSpec, build_round_step
from repro_torch.models import transformer

__all__ = ["run_one", "setup", "main", "COHORT_PARALLEL", "COHORT_SEQUENTIAL", "LOCAL_STEPS"]

COHORT_PARALLEL = 16  # clients per round, client_parallel
COHORT_SEQUENTIAL = 4  # clients per round, cohort_sequential
LOCAL_STEPS = 2
OPTS = ("remat_none", "mlstm_chunked", "attn_chunked", "moe_a2a")  # and mlstm_chunk_N, slstm_seg_N
MULTI_RANK = ("the port counts a step on one card; see ROADMAP.md section 1, item 6, "
              "'Multi-rank placement'")


def _cfg_for(arch: str, shape_name: str):
    """The arch's config; the sliding-window sibling of llama3.2-1b for the
    long_500k shape."""
    if arch == "llama3.2-1b" and shape_name == "long_500k":
        return get_config("llama3.2-1b-sw")
    return get_config(arch)


def _params(cfg):
    return transformer.init_params(cfg, None, "meta")


def _train_setup(cfg, shape, cohort=None):
    """The federated round step (the paper's technique is the train step):
    C clients (``cohort``, by default the round mode's), each
    ``LOCAL_STEPS`` local batches of ``global_batch / (C LOCAL_STEPS)``
    sequences."""
    if cohort is None:
        cohort = COHORT_PARALLEL if cfg.round_mode == "client_parallel" else COHORT_SEQUENTIAL
    b_local = shape.global_batch // (cohort * LOCAL_STEPS)
    if b_local < 1:
        raise ValueError(f"{cfg.name} {shape.name}: {shape.global_batch} sequences for {cohort} "
                         f"clients x {LOCAL_STEPS} steps")
    spec = RoundSpec(cohort=cohort, local_steps=LOCAL_STEPS, local_lr=0.02)
    meta = dict(device="meta")
    tok = torch.empty((cohort, LOCAL_STEPS, b_local, shape.seq_len), dtype=torch.int32, **meta)
    args = [_params(cfg), tok, tok, torch.empty((cohort,), dtype=torch.float32, **meta)]
    if cfg.frontend:
        fd = cfg.frontend_dim or cfg.d_model
        args.append(torch.empty((cohort, LOCAL_STEPS, b_local, cfg.frontend_seq, fd),
                                dtype=torch.float32, **meta))
    return build_round_step(cfg, spec), args, shape.global_batch * shape.seq_len


def _prefill_setup(cfg, shape, cohort=None):
    specs = input_specs(cfg, shape)

    def fn(params, tokens, aux=None):
        return transformer.prefill(params, cfg, tokens, aux)

    args = [_params(cfg), specs["tokens"]] + ([specs["aux_embeds"]] if "aux_embeds" in specs else [])
    return fn, args, shape.global_batch * shape.seq_len


def _decode_setup(cfg, shape, cohort=None):
    specs = input_specs(cfg, shape)

    def fn(params, token, caches):
        return transformer.decode_step(params, cfg, token, caches, specs["index"])

    # one new token a sequence
    return fn, [_params(cfg), specs["token"], specs["caches"]], shape.global_batch


def setup(cfg, shape, cohort=None):
    """``(fn, meta args, tokens processed)`` of one step of ``cfg`` at
    ``shape`` (a ``configs.InputShape``): the round step for ``train`` (of
    ``cohort`` clients, by default 16 in ``client_parallel`` and 4 in
    ``cohort_sequential``), ``prefill``, or ``decode`` (one token a
    sequence, caches of ``seq_len``)."""
    kind = {"train": _train_setup, "prefill": _prefill_setup, "decode": _decode_setup}
    return kind[shape.kind](cfg, shape, cohort)


def _apply_opts(cfg, opts):
    """The reference's perf-variant switches (its ``run_one``).  Without a
    mesh, ``attn_chunked`` and ``moe_a2a`` change nothing in the port, as in
    the reference: they are recorded."""
    replace = dataclasses.replace
    for o in opts:
        if o == "remat_none":
            cfg = replace(cfg, remat="none")
        elif o == "attn_chunked":
            cfg = replace(cfg, attn_impl="chunked")
        elif o == "moe_a2a":
            cfg = replace(cfg, moe_impl="a2a")
        elif o == "mlstm_chunked":
            cfg = replace(cfg, mlstm_impl="chunked")
        elif o.startswith("mlstm_chunk_"):
            cfg = replace(cfg, mlstm_impl="chunked", mlstm_chunk=int(o.rsplit("_", 1)[1]))
        elif o.startswith("slstm_seg_"):
            cfg = replace(cfg, slstm_segment=int(o.rsplit("_", 1)[1]))
        elif o == "seq_parallel":
            raise NotImplementedError(f"opt seq_parallel shards the sequence over a model axis: "
                                      f"{MULTI_RANK}")
        else:
            raise ValueError(f"unknown opt {o!r}; options: {OPTS} and mlstm_chunk_N, slstm_seg_N")
    return cfg


def run_one(arch: str, shape_name: str, opts: tuple = (), *, multi_pod: bool = False,
            mesh_shape=None) -> dict:
    """Count one (arch, shape) step on one card; the reference's record.

    opts: the reference's perf variants (``OPTS``, ``mlstm_chunk_N``,
    ``slstm_seg_N``).  ``multi_pod``, ``seq_parallel`` and a mesh of more
    than one device raise ``NotImplementedError``: the port has no
    multi-rank placement."""
    if multi_pod:
        raise NotImplementedError(f"--multi-pod lays the step over two pods: {MULTI_RANK}")
    if mesh_shape is not None and any(int(x) != 1 for x in mesh_shape):
        raise NotImplementedError(f"mesh_shape={tuple(mesh_shape)}: {MULTI_RANK}")
    shape = INPUT_SHAPES[shape_name]
    cfg = _apply_opts(_cfg_for(arch, shape_name), tuple(opts))
    kind = step_kind(cfg, shape)
    if kind is None:
        return {"arch": arch, "shape": shape_name, "multi_pod": False, "status": "skip",
                "reason": "full-attention arch skips long_500k (DESIGN.md section 4)"}
    t0 = time.perf_counter()
    fn, args, tokens_processed = setup(cfg, shape)
    cost, _ = count(fn, *args)
    trace_s = time.perf_counter() - t0
    n_active = active_params(cfg, _params(cfg))
    return {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": False,
        "opts": list(opts),
        "status": "ok",
        "kind": kind,
        "n_chips": 1,
        "round_mode": cfg.round_mode,
        "flops": cost.flops,
        "matmul_flops": cost.matmul_flops,
        "bytes_accessed": cost.bytes_accessed,
        "collective_bytes": cost.collective_bytes,
        "collectives": cost.collectives,
        "memory": cost.memory,
        "kernels": cost.kernels,
        "ops": cost.ops,
        "active_params": float(n_active),
        "tokens_processed": float(tokens_processed),
        "model_flops": float(model_flops(n_active, tokens_processed, kind)),
        "trace_s": round(trace_s, 1),
    }


def _sweep(out: str, timeout: int) -> None:
    """Every (arch, shape) combination, a subprocess each; one JSON file a
    combination under ``out``, kept across sweeps."""
    os.makedirs(out, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for arch in list_archs():
        for shape_name in INPUT_SHAPES:
            tag = f"{arch}__{shape_name}__sp"
            path = os.path.join(out, tag + ".json")
            if os.path.exists(path):
                print("cached", tag)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape_name]
            print(">>>", tag, flush=True)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                                      env=env)
                if proc.returncode == 0:  # the last line of stdout is the record
                    result = json.loads(proc.stdout.strip().splitlines()[-1])
                else:
                    result = {"arch": arch, "shape": shape_name, "multi_pod": False,
                              "status": "error", "stderr": proc.stderr[-4000:]}
            except subprocess.TimeoutExpired:
                result = {"arch": arch, "shape": shape_name, "multi_pod": False,
                          "status": "timeout"}
            with open(path, "w") as f:
                json.dump(result, f, indent=1)
            print("   ", result["status"],
                  f"trace={result['trace_s']}s" if result["status"] == "ok" else "", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--opt", default="", help="comma-separated perf variants")
    args = ap.parse_args(argv)
    if args.all:
        _sweep(args.out, args.timeout)
        return
    opts = tuple(o for o in args.opt.split(",") if o)
    result = run_one(args.arch, INPUT_SHAPES[args.shape].name, opts, multi_pod=args.multi_pod)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
