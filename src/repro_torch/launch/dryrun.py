"""Dry run for one H100: count every (arch x input shape) step of the port
without running it (the port of ``repro/launch/dryrun.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k [--opt remat_none]
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh 16,16
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --multi-pod
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

One chip of a mesh: ``--mesh D,M`` (or ``REPRO_MESH_SHAPE``; ``run_one``'s
``mesh_shape``) and ``--multi-pod`` ((2, 16, 16); a client_parallel
round's cohort multiplied by the pod size, as the reference's) count rank
0's program instead: under ``models.sharding.use_rules(mesh,
launch.sharding.activation_rules(...))`` on an ``analysis.cost.
CountingMesh`` (no process), with its blocks of the parameters
(``param_shardings``; ``fsdp`` for the cohort_sequential archs) and of
the caches (``cache_shardings``), where the mamba2 and mLSTM heads are
computed split (the ``state`` rule: the columns of each block's projection
and conv outputs a rank uses exchanged or gathered, its partial sums
all-reduced, a prefill's final states moved to the caches' layout by
all_to_all; no weight or state leaf of theirs gathered) and the sLSTM's leaves and states, and those of a block
whose heads the ``model`` line does not divide, are gathered at use; its
block of the round's
clients (client_parallel, whose client-axis collectives a
``CountingShard`` charges) or of each batch's rows (the rules' batch
axes; a MoE arch's dense dispatch charges the (E,) count gather and the
(2, E) all-reduce a block that couple the rows).  The record's
``n_chips`` is the mesh's size, ``mesh`` its shape (``16x16``); ``memory``,
``flops``, ``bytes_accessed``, ``collective_bytes`` and ``collectives``
are rank 0's.  Without a mesh (or with one of all ones) the count is one
card's, the default (``1xH100``), where the reference's default is its
production mesh.

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

from repro_torch.analysis.cost import CountingMesh, CountingShard, count
from repro_torch.analysis.report import MESH
from repro_torch.analysis.roofline import active_params, model_flops
from repro_torch.configs import INPUT_SHAPES, get_config, input_specs, list_archs, step_kind
from repro_torch.fed.round import RoundSpec, build_round_step
from repro_torch.launch import sharding as lsh
from repro_torch.launch.mesh import batch_axes, make_mesh
from repro_torch.models import sharding as msh
from repro_torch.models import transformer

__all__ = ["run_one", "setup", "main", "COHORT_PARALLEL", "COHORT_SEQUENTIAL", "LOCAL_STEPS"]

COHORT_PARALLEL = 16  # clients per round, client_parallel
COHORT_SEQUENTIAL = 4  # clients per round, cohort_sequential
LOCAL_STEPS = 2
OPTS = ("remat_none", "mlstm_chunked", "attn_chunked", "moe_a2a")  # and mlstm_chunk_N, slstm_seg_N
MULTI_RANK = "see ROADMAP.md section 1, 'What is left of the model axis'"


def _cfg_for(arch: str, shape_name: str):
    """The arch's config; the sliding-window sibling of llama3.2-1b for the
    long_500k shape."""
    if arch == "llama3.2-1b" and shape_name == "long_500k":
        return get_config("llama3.2-1b-sw")
    return get_config(arch)


def _params(cfg, mesh=None):
    """The ``meta`` parameters: whole, or rank 0's blocks on ``mesh``."""
    params = transformer.init_params(cfg, None, "meta")
    if mesh is None:
        return params
    return lsh.param_shardings(params, mesh, _fsdp(cfg), rank=0)


def _fsdp(cfg) -> bool:
    return cfg.round_mode == "cohort_sequential"


def _rows(n: int, mesh) -> int:
    """Rank 0's rows of n split over the batch axes (all n when they do
    not divide it: the rows are whole, as the reference's inputs are)."""
    if mesh is None:
        return n
    b = mesh.axis_size(batch_axes(mesh))
    return n // b if n % b == 0 and n > 1 else n


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_setup(cfg, shape, cohort=None, mesh=None):
    """The federated round step (the paper's technique is the train step):
    C clients (``cohort``, by default the round mode's, times the pods in
    client_parallel), each ``LOCAL_STEPS`` local batches of
    ``global_batch / (C LOCAL_STEPS)`` sequences.  On a mesh rank 0 takes
    its block of the clients (client_parallel) or of each batch's rows."""
    cp = cfg.round_mode == "client_parallel"
    if cohort is None:
        cohort = COHORT_PARALLEL if cp else COHORT_SEQUENTIAL
        if cp and mesh is not None and "pod" in mesh.axis_names:
            cohort *= mesh.shape["pod"]
    b_local = shape.global_batch // (cohort * LOCAL_STEPS)
    if b_local < 1:
        raise ValueError(f"{cfg.name} {shape.name}: {shape.global_batch} sequences for {cohort} "
                         f"clients x {LOCAL_STEPS} steps")
    spec = RoundSpec(cohort=cohort, local_steps=LOCAL_STEPS, local_lr=0.02)
    shard, c_here, rows = None, cohort, b_local
    if mesh is not None and cp:
        b_axes = batch_axes(mesh)
        shard = CountingShard.from_mesh(mesh, axis=b_axes[0] if len(b_axes) == 1 else b_axes)
        lo, hi = shard.local_range(cohort, 0)
        c_here, shard = hi - lo, (shard if shard.splits else None)
    elif mesh is not None:
        rows = _rows(b_local, mesh)
    tok = _meta((c_here, LOCAL_STEPS, rows, shape.seq_len), torch.int32)
    args = [_params(cfg, mesh), tok, tok, _meta((c_here,), torch.float32)]
    if cfg.frontend:
        fd = cfg.frontend_dim or cfg.d_model
        args.append(_meta((c_here, LOCAL_STEPS, rows, cfg.frontend_seq, fd), torch.float32))
    return build_round_step(cfg, spec, shard=shard), args, shape.global_batch * shape.seq_len


def _prefill_setup(cfg, shape, cohort=None, mesh=None):
    specs = input_specs(cfg, shape)
    rows = _rows(shape.global_batch, mesh)

    def fn(params, tokens, aux=None):
        return transformer.prefill(params, cfg, tokens, aux, batch=shape.global_batch)

    args = [_params(cfg, mesh), specs["tokens"][:rows]]
    if "aux_embeds" in specs:
        args.append(specs["aux_embeds"][:rows])
    return fn, args, shape.global_batch * shape.seq_len


def _decode_setup(cfg, shape, cohort=None, mesh=None):
    specs = input_specs(cfg, shape)
    caches = specs["caches"]
    if mesh is not None:
        c_specs = lsh.cache_shardings(caches, mesh, shape.seq_len, shape.global_batch)
        caches = [_cut(c, s, mesh) for c, s in zip(caches, c_specs)]

    def fn(params, token, caches):
        return transformer.decode_step(params, cfg, token, caches, specs["index"],
                                       max_seq=shape.seq_len, batch=shape.global_batch)

    token = specs["token"][:_rows(shape.global_batch, mesh)]
    # one new token a sequence
    return fn, [_params(cfg, mesh), token, caches], shape.global_batch


def _cut(cache, spec, mesh):
    if isinstance(cache, dict):
        return {k: _cut(cache[k], spec[k], mesh) for k in cache}
    return lsh.block_of(cache, spec, mesh, rank=0)


def setup(cfg, shape, cohort=None, mesh=None):
    """``(fn, meta args, tokens processed)`` of one step of ``cfg`` at
    ``shape`` (a ``configs.InputShape``): the round step for ``train`` (of
    ``cohort`` clients, by default 16 in ``client_parallel`` and 4 in
    ``cohort_sequential``), ``prefill``, or ``decode`` (one token a
    sequence, caches of ``seq_len``); on ``mesh`` (a ``CountingMesh``),
    rank 0's share (module docstring)."""
    kind = {"train": _train_setup, "prefill": _prefill_setup, "decode": _decode_setup}
    return kind[shape.kind](cfg, shape, cohort, mesh)


def mesh_for(multi_pod: bool = False, mesh_shape=None):
    """The dry run's ``CountingMesh``: (2, 16, 16) with ``multi_pod``, else
    ``mesh_shape``, else ``REPRO_MESH_SHAPE``; None (one card) without one
    or for a mesh of all ones."""
    if multi_pod:
        mesh_shape = (2, 16, 16)
    elif mesh_shape is None and os.environ.get("REPRO_MESH_SHAPE"):
        mesh_shape = tuple(int(x) for x in os.environ["REPRO_MESH_SHAPE"].split(","))
    if mesh_shape is None:
        return None
    m = make_mesh(mesh_shape)
    return None if m.size == 1 else CountingMesh(m.axis_names, m.sizes)


def rules_for(mesh, cfg, shape_name: str, kind: str) -> dict:
    """The reference's activation rules for the step, the batch axes
    dropped where they do not divide the step's rows."""
    cp = kind == "train" and cfg.round_mode == "client_parallel"
    rules = lsh.activation_rules(mesh, long_context=shape_name == "long_500k",
                                 client_parallel=cp)
    shape = INPUT_SHAPES[shape_name]
    rows = shape.global_batch
    if kind == "train" and not cp:
        rows = shape.global_batch // (COHORT_SEQUENTIAL * LOCAL_STEPS)
    if _rows(rows, mesh) == rows:
        rules["batch"] = None
    return rules


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
    """Count one (arch, shape) step, the reference's record: on one card,
    or as one chip (rank 0) of the mesh ``mesh_for(multi_pod,
    mesh_shape)``.

    opts: the reference's perf variants (``OPTS``, ``mlstm_chunk_N``,
    ``slstm_seg_N``); ``seq_parallel`` raises ``NotImplementedError``."""
    shape = INPUT_SHAPES[shape_name]
    cfg = _apply_opts(_cfg_for(arch, shape_name), tuple(opts))
    kind = step_kind(cfg, shape)
    mesh = mesh_for(multi_pod, mesh_shape)
    multi_pod = mesh is not None and "pod" in mesh.axis_names
    if kind is None:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "skip",
                "reason": "full-attention arch skips long_500k (DESIGN.md section 4)"}
    t0 = time.perf_counter()
    fn, args, tokens_processed = setup(cfg, shape, mesh=mesh)
    if mesh is None:
        cost, _ = count(fn, *args)
    else:
        with msh.use_rules(mesh, rules_for(mesh, cfg, shape_name, kind), fsdp=_fsdp(cfg)):
            cost, _ = count(fn, *args)
    trace_s = time.perf_counter() - t0
    n_active = active_params(cfg, _params(cfg))
    place = {} if mesh is None else {
        "mesh": "x".join(str(s) for s in mesh.sizes),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in transformer.tree_leaves(args[0])),
    }
    return {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "opts": list(opts),
        "status": "ok",
        "kind": kind,
        **place,
        "n_chips": 1 if mesh is None else mesh.size,
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


def _sweep(out: str, timeout: int, mesh_args: tuple = (), mesh=None) -> None:
    """Every (arch, shape) combination, a subprocess each; one JSON file a
    combination under ``out``, kept across sweeps, tagged with its mesh
    (``mesh_for``'s): ``__sp`` for (16, 16), ``__mp`` for (2, 16, 16),
    ``__1xH100`` for one card, else the sizes (``__2x2``)."""
    os.makedirs(out, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    name = MESH if mesh is None else "x".join(str(s) for s in mesh.sizes)
    pod = {"16x16": "sp", "2x16x16": "mp"}.get(name, name)
    for arch in list_archs():
        for shape_name in INPUT_SHAPES:
            tag = f"{arch}__{shape_name}__{pod}"
            path = os.path.join(out, tag + ".json")
            if os.path.exists(path):
                print("cached", tag)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape_name, *mesh_args]
            print(">>>", tag, flush=True)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                                      env=env)
                if proc.returncode == 0:  # the last line of stdout is the record
                    result = json.loads(proc.stdout.strip().splitlines()[-1])
                else:
                    result = {"arch": arch, "shape": shape_name, "multi_pod": pod == "mp",
                              "status": "error", "stderr": proc.stderr[-4000:]}
            except subprocess.TimeoutExpired:
                result = {"arch": arch, "shape": shape_name, "multi_pod": pod == "mp",
                          "status": "timeout"}
            with open(path, "w") as f:
                json.dump(result, f, indent=1)
            print("   ", result["status"],
                  f"trace={result['trace_s']}s" if result["status"] == "ok" else "", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true", help="one chip of (2, 16, 16)")
    ap.add_argument("--mesh", default="", metavar="D,M",
                    help="one chip of this (data, model) or (pod, data, model) mesh "
                    "(REPRO_MESH_SHAPE too); default one card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--opt", default="", help="comma-separated perf variants")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    if args.all:
        _sweep(args.out, args.timeout, ("--multi-pod",) if args.multi_pod else
               (("--mesh", args.mesh) if args.mesh else ()), mesh_for(args.multi_pod, mesh_shape))
        return
    opts = tuple(o for o in args.opt.split(",") if o)
    result = run_one(args.arch, INPUT_SHAPES[args.shape].name, opts, multi_pod=args.multi_pod,
                     mesh_shape=mesh_shape)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
