#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--only PHASE [PHASE ...]]

Phases, each failing loudly (non-zero exit, no result line):

1. device — a CUDA GPU must be visible; print its name and power limit;
2. build  — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, one nvcc per source, all started together, and
   print the build times and the tensor-core instructions of kernels 7 and
   8 (HMMA in ``cuobjdump -sass``; none fails);
3. kernels — hold each of the eight kernels against its plain PyTorch
   version on the card at the main path's shapes (and one large shape),
   check that kernel 1's output and kernels 2–5's norms, error scalar or
   counts and sums are bitwise repeatable, that kernels 2-5 are one
   device kernel a call and kernels 2-4 give the same bits on two
   streams at once, and time
   kernel, plain version, the library call
   computing the same function (where there is one) and the bound, after a
   timing floor (a 1-element ``add_`` timed the same way); kernel 4 with
   its share of the bytes bound and the HBM rate of its binding probe;
   kernel 1 also at the femnist example's oracle shape (200, 44,308);
   kernel 5 over sorted scores (the solve's input) at the solve's sizes,
   shuffled and ragged at M = 10^6, against its bytes bound; kernels 6
   (rmsnorm) and 7 (flash_attention) at the serving path's shapes, kernel 7
   in all four modes, at a ragged S, with grouped-query heads, at (m)'s
   shared-attention shape, bf16 and f32, each row naming the kernel that
   ran (tensor cores for bf16, CUDA cores for f32);
   kernel 8 (ssd_scan) at zamba2-1.2b's prefill shape as the model passes
   it, at the half of its heads a rank of (ma5) runs, with b and c per
   row, at a ragged S, under strong decays, y and the
   final state, each kernel-8 row with its bound at the TF32 tensor-core
   rate and at the f32 rate; kernel 6's host time a call at decode's shape,
   through the wrapper and through ``torch.autograd.Function.apply``;
   ranks — the client axis over two ranks: (r1) femnist v1 oracle with
   K-Vib, 5 rounds (kernel 1 at (2, 100) x (100, 44,308) a rank), (r2) (h)
   with int8 deltas and error feedback (kernel 4 on a rank's slots) and
   (r2') (h) itself, (r3) smollm-360m whole, client_parallel, C = 4, 2
   rounds (kernel 2 on a rank's slots) and (r3') its two layers in f32,
   (r4) gemma2-27b one pattern deep, cohort_sequential, C = 1, one round,
   and (r4') gemma2 reduced in f32 at local batch 3, each through
   ``api.run`` in this process (S = 1) and in two processes over gloo on
   the card with ``execution.mesh_shape=(2, 1)`` (this script with
   ``--ranks-worker``): counts and cohorts exact, floats within each row's
   tolerance, both ranks bitwise equal, every rank's kernel launches exact
   (kernel 5's ladder on each rank's block), collectives a round, each
   rank's resident (N,) bytes and seconds both ways
   (``--only ranks`` runs the build and this phase alone);
   model_axis — the model axis on two processes over gloo on the card at
   mesh (1, 2) against one process (the comment above ``MA_MESH``): (ma1)
   smollm-360m's prefill and round step and (ma2) qwen3-moe's one-layer
   prefill (dense dispatch and a2a) as each rank's share under
   ``use_rules``, each gap (the round's on its update, kernel 2's d on
   each rank against its plain sum, and a planted fault that the update's
   limit must catch; the round again in f32, its update's gap against
   f32 rounding), the collectives, each process's peak and the
   kernels each rank launched (kernels 6 and 7; 2 in the round); (ma3)
   ``api.run`` on (1, 2) bitwise S = 1; (ma5) zamba2-1.2b and xlstm-125m
   whole, a prefill and 16 decode steps, the mamba2 and mLSTM heads
   computed on a rank's block over recurrent caches split over ``model``
   (the comment above ``MA5``): each step's logits, greedy tokens, each
   rank's state blocks against one process's, a step's collectives and
   bytes against the count's and the bytes' limit; (ma6) a reduced qwen3 MoE
   cohort_sequential round through ``api.run`` on (2, 1), rows split
   2 / 1 at a capacity that drops pairs, against S = 1; (ma4) the dry run
   of one chip of (16, 16) and (2, 16, 16) on the card's CPU (llama3-405b
   and smollm-360m train_4k, zamba2-1.2b decode_32k, xlstm-125m
   long_500k) and (ma1)'s prefill counted for one rank, its peak against
   each process's (``--only model_axis`` runs the build and this phase
   alone);
4. path — ``repro_torch.api.run(spec)`` with no device argument (so on the
   GPU) for the paper's logistic-regression spec and the tiny-LM spec in
   oracle and deployable mode, three compressed specs (int8 / fp8 deltas,
   with and without error feedback), then (g) the logistic-regression spec
   with ``execution.sampler_axis`` (bitwise the run without it), (h) the
   deployable tiny LM with the sharded solve, Markov availability, a
   deadline and buffered async, (i) the oracle tiny LM with int8 deltas,
   Bernoulli availability and the quantized async ring, counting kernel
   launches per run; then ``kernels.ops.aggregate_cohort_updates`` on a
   stacked tiny-LM delta dict, and (j) the reference's million-client
   sampler round (K-Vib, K=64, sharded solve + draw + update) at
   N = 10^4, 10^5, 10^6; then serving: (k) ``python -m
   repro_torch.launch.serve``'s demo at full width and depth (smollm-360m,
   bf16, batch 8, prompt 512, 64 new tokens, pages of 16), (l) gemma2-27b
   at full width cut to one (attn_local, attn) pattern through
   ``repro_torch.serve.ServeEngine``, and (m) the launcher serving
   zamba2-1.2b (the Mamba2 hybrid) at full width and depth, each with its
   exact kernel 6, 7 and 8 launch counts and every kernel-7 launch on the
   tensor cores; (l)'s prefill with kernel 7 on the tensor cores against
   the CUDA-core kernel;
   samplers — each of the nine registry samplers (K-Vib, the paper's
   baselines with the RSP procedure, the oracle, clustered K-Vib) through
   ``api.run`` on the logistic-regression oracle spec, and vrb on the
   deployable tiny LM, on the card and on the CPU from one replayed
   source: equal draws, parameters and metrics within 1e-5, kernel 1 (or
   2) once a round, seconds a round on the card;
   examples — the paper's four examples (``repro_torch.examples``) on the
   card at full width, rounds cut (quickstart at its defaults,
   synthetic_regret 60 rounds and one seed, budget_sweep 30 rounds,
   femnist_style 15 rounds), then ``repro_torch.bench.tables`` on their
   JSON: every fig2 / fig3b / fig4 row present and finite, kernel 1 once a
   round, each spec's wall seconds after a warm-up;
   checkpoint — the deployable tiny LM with K-Vib, the logreg oracle with
   vrb and (i), each stopped after one 2-round segment and resumed through
   a fresh ``CheckpointManager``: History and final parameters bitwise the
   uninterrupted card run; ``exact_oracle_equiv`` at C = N against the
   oracle logreg run, with the largest parameter gap;
   zoo — the zoo federated round through ``api.run(spec)`` with
   ``kind="zoo"``: (n) smollm-360m and (o) zamba2-1.2b at full width and
   depth (client_parallel, C = 8), (p) gemma2-27b at full width one
   (attn_local, attn) pattern deep (cohort_sequential, C = 4), bf16, each
   with exact launches of kernels 6-8 a round and kernel 7 on the tensor
   cores; at reduced width int8 + error feedback (kernel 4) and
   ``sampler_axis`` (kernel 5); a 2-layer full-width smollm round in f32 on
   the card and the CPU from one replayed source; a preempted and resumed
   zoo run, bitwise; ``repro_torch.examples.fed_lm`` (tiny and zoo) and the
   fig5 rows; one round of (n) and of (o) under the profiler (forward
   kernels against the PyTorch backwards of kernels 6-8, GEMMs,
   elementwise);
   serve_loop — the train-to-serve loop: (s) smollm-360m and (t)
   zamba2-1.2b at full width and depth, each ``python -m
   repro_torch.launch.train --compiled --ckpt DIR/fl --ckpt-every N`` and
   ``python -m repro_torch.launch.serve --follow DIR/fl_ckpts`` as two
   processes on the card: both exit 0, the summary line's ``last_step`` at
   the horizon, ``swaps == promotions``, 1 to N boundaries decided, the
   engine's parameters at their addresses, the gate's launches of kernels
   6-8 exact (they go into the kernels line); restore and gate seconds,
   decode tokens/s with the trainer running and with none, the trainer's
   seconds a round with the follower, alone, and in the zoo phase; a
   boundary's save and restore alone; (u) ``python -m
   repro_torch.examples.fed_lm --serve --rounds 6 --clients 8 --budget 3``;
   (v) swap-heavy against static decode on (k)'s engine, the ratio printed
   and not gated; the launcher killed after one segment and resumed,
   bitwise;
   remat — ``remat`` "full" against "none" on reduced
   smollm, zamba2 (its ``shared`` block), qwen3-moe and xlstm in f32:
   bitwise-equal losses and gradients under ``vmap(grad)`` on the card and
   on the CPU, "full" launching each decoder group's kernels once more; an
   xlstm-125m round step with ``slstm_segment`` 16 against 0; peak memory
   and seconds a round both ways for (n), (aa) and (n) at seq 1024
   (``--only remat=n,o,z,aa,n1024`` runs the build and this phase alone
   with those cells);
   lint — ``python -m repro_torch.analysis.lint --fast`` over the whole
   registry exits 0; ``launch.train --lint`` lints and trains a reduced
   spec on the card and exits 1 on a planted float64 leak;
   dryrun — four steps counted by ``launch.dryrun``'s setups on ``meta``
   tensors and then run on the card (``DRYRUN_STEPS``: (ag) smollm-360m
   prefill 8 x 512, (ah) its round C = 8 at seq 64, (ai) zamba2-1.2b
   prefill 8 x 512, (aj) a smollm decode step over 576-token caches): each
   predicted peak within 10% or 256 MB of the card's, kernels 6-8's
   launches equal to the counted calls, the step's time against its
   roofline at ``analysis.roofline.HW``; then ``python -m
   repro_torch.launch.dryrun`` at full width for xlstm-125m decode_32k and
   smollm-360m train_4k and ``python -m repro_torch.analysis.report`` over
   them (``--only kernels dryrun`` runs the build and these phases alone);
   autograd — gradients through kernels 6-8 (kernel forward, PyTorch
   backward) equal the CPU's in f32: each wrapper, then ``loss_fn`` of a
   reduced smollm-360m and a reduced zamba2-1.2b, with the kernels counted in
   the forward; ``vmap(grad_and_value(loss_fn))`` over two clients'
   parameters equals a loop; bf16 gradients are finite, kernel 8's at a
   decay of -0.75 a step;
5. agreement — small runs on the GPU, uncompressed and int8-compressed, and
   runs (g) and (h) equal the same runs on the CPU (plain PyTorch path) fed
   the same recorded draws; a 2-layer full-width smollm-360m served in f32 on
   the GPU and on the CPU from the same weights gives the same greedy tokens
   and logits within 1e-4, and bf16 prefill + decode on the GPU agrees with
   the full forward (teacher forcing) within 2e-2; a 3-layer full-width
   zamba2 hybrid in f32 likewise gives the CPU's greedy tokens and logits
   within 1e-4;
6. trace — host syncs in the round bodies and per decode step, then one
   tiny-LM round loop and one serving prefill and decode of (k) and of (m)
   under ``torch.profiler``: the device's busy share, the kernels that take
   its time, kernel 6's device time a launch in (k)'s and (m)'s decode
   and, for (m), kernel 8's share of the prefill; (k)'s and (m)'s
   prefill with kernel 7 on the tensor cores against the CUDA-core kernel.

Prints a ``{"kernels": [...]}`` JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.roofline import HW  # noqa: E402  (the H100's data-sheet peaks)

HBM_BYTES_PER_S = HW.hbm_bw  # memory rate
F32_FLOPS_PER_S = HW.f32_flops  # f32 outside the tensor cores
TF32_FLOPS_PER_S = HW.tf32_flops  # dense TF32 tensor cores
BF16_FLOPS_PER_S = HW.peak_flops  # dense bf16 tensor cores
LIBRARIES = ("fused_weighted_agg", "sharded_waterfill", "rmsnorm", "flash_attention",
             "ssd_scan")  # csrc/<name>.cu
SOURCE = {
    name: "src/repro_torch/kernels/csrc/fused_weighted_agg.cu"
    for name in ("fused_weighted_agg", "fused_multi_weighted_agg",
                 "fused_cohort_agg_and_error", "fused_dequant_cohort_agg")
}
SOURCE["waterfill_level_stats"] = "src/repro_torch/kernels/csrc/sharded_waterfill.cu"
SOURCE["rmsnorm"] = "src/repro_torch/kernels/csrc/rmsnorm.cu"
SOURCE["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCE["ssd_scan"] = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = {
    "fused_weighted_agg": "src/repro/kernels/fused_weighted_agg.py:134",
    "fused_multi_weighted_agg": "src/repro/kernels/fused_weighted_agg.py:174",
    "fused_cohort_agg_and_error": "src/repro/kernels/fused_weighted_agg.py:221",
    "fused_dequant_cohort_agg": "src/repro/kernels/fused_weighted_agg.py:296",
    "waterfill_level_stats": "src/repro/kernels/sharded_waterfill.py:72",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:27",
    "flash_attention": "src/repro/kernels/flash_attention.py:86",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:74",
}
# The serving runs: (k) the launcher's demo at full width and depth,
# (l) gemma2-27b at full width, one pattern deep, (m) the launcher serving
# the Mamba2 hybrid at full width and depth.
SERVE_K = ["--arch", "smollm-360m", "--batch", "8", "--prompt-len", "512",
           "--new-tokens", "64", "--page-size", "16"]
SERVE_M = ["--arch", "zamba2-1.2b", "--batch", "8", "--prompt-len", "512",
           "--new-tokens", "64", "--page-size", "16"]
ZAMBA2_PARAMS = 1_053_612_800
GEMMA_L = dict(batch=8, prompt_len=512, new_tokens=16, page_size=16)
ROUNDS = 5
LADDER_PASSES = 5  # kernel 5 launches per sharded K-Vib solve (core/solver.py)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


_T0 = time.perf_counter()


def phase(name: str) -> None:
    """Start a phase, with the seconds since the script started."""
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


# -- 1. device ----------------------------------------------------------------


def device_phase(torch):
    phase("device")
    check(torch.cuda.is_available(), "no CUDA GPU is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    # Plain f32 everywhere: the port's reference numerics (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# -- 2. build -----------------------------------------------------------------


def build_phase():
    phase("build")
    from repro_torch.kernels.build import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        infos = list(pool.map(lambda name: build_library(name, force=True), LIBRARIES))
    for info in infos:
        print(f"nvcc: {info['command']}")
        print(f"built {Path(info['path']).name} in {info['seconds']:.2f} s")
    print(f"all {len(LIBRARIES)} builds, in parallel: {time.perf_counter() - t0:.2f} s")
    flash = infos[LIBRARIES.index("flash_attention")]
    hmma = sass_counts(flash["path"], "HMMA")
    print(f"SASS HMMA per flash_attention kernel: {hmma}")
    check(all(n > 0 for k, n in hmma.items() if "flash_fwd_tc_kernel" in k) and
          any("flash_fwd_tc_kernel" in k for k in hmma),
          "the tensor-core flash_attention kernels hold no HMMA instruction")
    hmma = sass_counts(infos[LIBRARIES.index("ssd_scan")]["path"], "HMMA")
    print(f"SASS HMMA per ssd_scan kernel: {hmma}")
    check(bool(hmma) and all(n > 0 for n in hmma.values()),
          "an ssd_scan kernel holds no HMMA instruction (kernel 8 runs on the tensor cores)")


# CPU-only subprocesses (the lint sweep, the dry-run CLI) never touch the
# card: they start right after the build, one after another on a thread
# with two intra-op threads each, and run beside the card's phases; the
# phase that reads one waits for it.
DRYRUN_CLI = (("xlstm-125m", "decode_32k"), ("smollm-360m", "train_4k"))
CPU_JOBS = {
    "lint": ["-m", "repro_torch.analysis.lint", "--fast", "--quiet"],
    **{f"dryrun {arch} {shape}": ["-m", "repro_torch.launch.dryrun", "--arch", arch,
                                  "--shape", shape] for arch, shape in DRYRUN_CLI},
    # (ma4): one chip of the production meshes.
    "dryrun llama3-405b train_4k 16x16": ["-m", "repro_torch.launch.dryrun", "--arch",
                                          "llama3-405b", "--shape", "train_4k", "--mesh", "16,16"],
    "dryrun smollm-360m train_4k 2x16x16": ["-m", "repro_torch.launch.dryrun", "--arch",
                                            "smollm-360m", "--shape", "train_4k", "--multi-pod"],
    "dryrun zamba2-1.2b decode_32k 16x16": ["-m", "repro_torch.launch.dryrun", "--arch",
                                            "zamba2-1.2b", "--shape", "decode_32k", "--mesh",
                                            "16,16"],
    "dryrun xlstm-125m long_500k 2x16x16": ["-m", "repro_torch.launch.dryrun", "--arch",
                                            "xlstm-125m", "--shape", "long_500k", "--multi-pod"],
}
_CPU_RESULTS: dict = {}
_CPU_PROCS: list = []


@atexit.register
def _stop_cpu_jobs() -> None:
    """The script exits with no job of its own left running."""
    for p in _CPU_PROCS:
        if p.poll() is None:
            p.kill()


def start_cpu_jobs(names) -> None:
    """Run ``CPU_JOBS[name]`` for each of ``names``, in order, on a thread:
    each result ``(returncode, stdout, stderr, seconds)`` lands in
    ``_CPU_RESULTS`` behind an event."""
    import threading

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2",
           "CUDA_VISIBLE_DEVICES": ""}
    for name in names:
        _CPU_RESULTS[name] = [threading.Event(), None]

    def run():
        for name in names:
            t0 = time.perf_counter()
            p = subprocess.Popen([sys.executable, *CPU_JOBS[name]], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
            _CPU_PROCS.append(p)
            try:
                out, err = p.communicate(timeout=600)
                res = (p.returncode, out, err)
            except subprocess.TimeoutExpired as e:
                p.kill()
                res = (-1, "", f"timed out after {e.timeout} s")
            _CPU_RESULTS[name][1] = (*res, time.perf_counter() - t0)
            _CPU_RESULTS[name][0].set()

    threading.Thread(target=run, daemon=True).start()


def cpu_job(name: str) -> tuple:
    """``CPU_JOBS[name]``'s ``(returncode, stdout, stderr, seconds)``: the
    background run's, waited for, or run here when none was started."""
    if name not in _CPU_RESULTS:
        start_cpu_jobs([name])
    event, result = _CPU_RESULTS[name]
    event.wait()
    return _CPU_RESULTS[name][1]


def sass_counts(library: str, opcode: str) -> dict:
    """Instructions whose opcode starts with ``opcode`` in each kernel (by
    its mangled name) of a built library (``cuobjdump -sass``, next to
    nvcc)."""
    from repro_torch.kernels.build import _nvcc

    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass", library],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            counts[name] = 0
        elif name and f" {opcode}" in line:
            counts[name] += 1
    return counts


# -- 3. kernels ---------------------------------------------------------------


def time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Median device time of one call, CUDA events around each call, with
    ``flush()`` enqueued before every call: in the kernels phase a 512 MB
    write that flushes the L2 cache (50 MB).  It also keeps the stream busy
    while the host enqueues the call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[iters // 2]


def measure(torch, flush, kern, plain, lib, n_bytes: int, flops: int, err: float,
            flops_per_s: float = F32_FLOPS_PER_S) -> dict:
    """One kernel at one shape: the times of kernel, plain version and
    library call (None where there is none), and the bound: the larger of
    the bytes over the memory rate and the operations over the peak rate of
    their type (f32 unless given)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return {
        "kernel_ms": time_ms(torch, kern, flush),
        "plain_ms": time_ms(torch, plain, flush),
        "library_ms": time_ms(torch, lib, flush) if lib else None,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "max_abs_err": err,
    }


def report(name: str, what: str, row: dict, lib_txt: str, extra: str = "") -> None:
    lib = f"{row['library_ms']:.5f}" if row["library_ms"] is not None else lib_txt
    print(
        f"{name} {what}: kernel_ms={row['kernel_ms']:.5f} library_ms={lib} "
        f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
        f"({row['bound_ms'] / row['kernel_ms']:.1%} of bound) "
        f"max_abs_err={row['max_abs_err']:.3g}{extra}",
        flush=True,
    )


def kernel_phase(torch):
    phase("kernels")
    from repro_torch.kernels import fused_weighted_agg as fwa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(512 * 2**20 // 4, dtype=torch.float32, device=dev).zero_
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(torch, lambda: one.add_(1.0), flush)
    print(f"timing floor: a 1-element add_ timed as the kernels are, {floor_ms:.5f} ms",
          flush=True)
    shapes = [  # (label, C, D): the main path's shapes, then one large ragged one
        ("oracle tiny_lm", 50, 114688),
        ("deployable tiny_lm", 10, 114688),
        ("oracle logreg", 100, 610),
        ("femnist v1 mlp", 200, 44308),  # the femnist example's oracle round at v1
        ("large ragged", 20, 2**24 + 3),
    ]
    path_shape = {  # the shape each kernel's JSON row reports
        "fused_weighted_agg": ("deployable tiny_lm", "torch.float32"),
        "fused_multi_weighted_agg": ("oracle tiny_lm", "torch.float32"),
        "fused_cohort_agg_and_error": ("deployable tiny_lm", "torch.float32"),
        "fused_dequant_cohort_agg": ("oracle tiny_lm", "int8"),
    }
    rows, max_err = {}, {k: 0.0 for k in path_shape}
    for label, c, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dtype).element_size()
            tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
            g = torch.randn(c, d, generator=gen, device=dev).to(dtype)
            w2 = torch.rand(2, c, generator=gen, device=dev)
            w, lam = w2[0].contiguous(), (0.1 * w2[1]).contiguous()
            w2c = torch.stack([w, w - lam])

            # Kernel 1 (M = 2) against its plain version; bitwise repeatable.
            out = fwa.fused_multi_weighted_agg(g, w2c)
            want = ref.multi_weighted_agg_reference(g, w2c)
            out_again = fwa.fused_multi_weighted_agg(g, w2c)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, **tol)
            check(torch.equal(out, out_again), "fused_multi_weighted_agg is not repeatable")
            err1 = float((out - want).abs().max())
            # Kernel 2 against its plain version; bitwise repeatable.
            d_out, sq = fwa.fused_cohort_agg_and_error(g, w, lam)
            d_want, sq_want = ref.cohort_agg_and_error_reference(g, w, lam)
            sq_again = fwa.fused_cohort_agg_and_error(g, w, lam)[1]
            torch.cuda.synchronize()
            torch.testing.assert_close(d_out, d_want, **tol)
            torch.testing.assert_close(sq, sq_want, rtol=2e-2 if es == 2 else 1e-4, atol=0.0)
            check(torch.equal(sq, sq_again), "fused_cohort_agg_and_error is not repeatable")
            err2 = float((d_out - d_want).abs().max())
            rel_sq = float((sq - sq_want).abs() / sq_want.abs())
            # Kernel 3 against its plain version; norms bitwise repeatable.
            d3, n3 = fwa.fused_weighted_agg(g, w)
            d3_want, n3_want = ref.weighted_agg_reference(g, w)
            n3_again = fwa.fused_weighted_agg(g, w)[1]
            torch.cuda.synchronize()
            torch.testing.assert_close(d3, d3_want, **tol)
            torch.testing.assert_close(n3, n3_want, rtol=1e-4, atol=0.0)
            check(torch.equal(n3, n3_again), "fused_weighted_agg norms are not repeatable")
            err3 = float((d3 - d3_want).abs().max())
            rel_n3 = float(((n3 - n3_want).abs() / n3_want.abs()).max())
            for name, e in (("fused_multi_weighted_agg", err1),
                            ("fused_cohort_agg_and_error", err2), ("fused_weighted_agg", err3)):
                max_err[name] = max(max_err[name], e)

            f32 = dtype == torch.float32
            g_bytes = c * d * es
            for name, kern, plain, lib, n_bytes, flops, err, extra in (
                ("fused_multi_weighted_agg", lambda: fwa.fused_multi_weighted_agg(g, w2c),
                 lambda: ref.multi_weighted_agg_reference(g, w2c),
                 (lambda: torch.matmul(w2c, g)) if f32 else None,
                 g_bytes + 2 * c * 4 + 2 * d * 4, 4 * c * d, err1, ""),
                ("fused_cohort_agg_and_error", lambda: fwa.fused_cohort_agg_and_error(g, w, lam),
                 lambda: ref.cohort_agg_and_error_reference(g, w, lam),
                 (lambda: torch.matmul(w2c, g)) if f32 else None,
                 g_bytes + 2 * c * 4 + (d + 1) * 4, 4 * c * d + 2 * d, err2,
                 f" err_scalar_rel={rel_sq:.3g}"),
                ("fused_weighted_agg", lambda: fwa.fused_weighted_agg(g, w),
                 lambda: ref.weighted_agg_reference(g, w),
                 (lambda: (torch.mv(g.t(), w), g.square().sum(1))) if f32 else None,
                 g_bytes + c * 4 + d * 4 + c * 4, 4 * c * d, err3,
                 f" norms_rel={rel_n3:.3g}"),
            ):
                row = measure(torch, flush, kern, plain, lib, n_bytes, flops, err)
                row["shape"] = {"C": c, "D": d, "dtype": str(dtype)[6:]}
                rows[(name, label, str(dtype))] = row
                lib_name = "mv+square.sum (2 calls)" if name == "fused_weighted_agg" else "matmul"
                report(name, f"{label} C={c} D={d} {str(dtype)[6:]}", row,
                       "n/a (no bf16 x f32 call)", extra + (f" library={lib_name}" if f32 else ""))
            if (label, dtype) == ("deployable tiny_lm", torch.float32):
                cohort_args = (g, w, lam)
            del g, out, out_again, want, d_out, d_want, d3, d3_want
    k3 = {dt: rows[("fused_weighted_agg", "oracle logreg", dt)]
          for dt in ("torch.float32", "torch.bfloat16")}
    print(f"fused_weighted_agg oracle logreg (100, 610): f32 kernel_ms="
          f"{k3['torch.float32']['kernel_ms']:.5f} library_ms="
          f"{k3['torch.float32']['library_ms']:.5f} (torch.mv + square().sum(1)); bf16 "
          f"kernel_ms={k3['torch.bfloat16']['kernel_ms']:.5f} plain_ms="
          f"{k3['torch.bfloat16']['plain_ms']:.5f}", flush=True)
    k1 = rows[("fused_multi_weighted_agg", "femnist v1 mlp", "torch.float32")]
    print(f"fused_multi_weighted_agg femnist v1 (2, 200) x (200, 44308) f32: kernel_ms="
          f"{k1['kernel_ms']:.5f} bound_ms={k1['bound_ms']:.5f} ({k1['bound_by']}) "
          f"library_ms={k1['library_ms']:.5f} (torch.matmul) plain_ms={k1['plain_ms']:.5f}",
          flush=True)
    rows.update(dequant_kernel_phase(torch, fwa, ref, gen, flush, max_err))
    max_err["waterfill_level_stats"] = 0.0
    rows.update(waterfill_kernel_phase(torch, gen, flush, max_err, floor_ms))
    path_shape["waterfill_level_stats"] = ("path", "float32")
    max_err["rmsnorm"] = max_err["flash_attention"] = 0.0
    rows.update(rmsnorm_kernel_phase(torch, gen, flush, max_err))
    rows.update(flash_kernel_phase(torch, gen, flush, max_err))
    path_shape["rmsnorm"] = ("prefill smollm", "bfloat16")
    path_shape["flash_attention"] = ("prefill smollm causal", "bfloat16")
    max_err["ssd_scan"] = 0.0
    rows.update(ssd_kernel_phase(torch, gen, flush, max_err))
    path_shape["ssd_scan"] = ("prefill zamba2", "float32")
    cohort_checks(torch, fwa, gen, *cohort_args)  # last: it runs torch.profiler
    return rows, max_err, path_shape


def one_device_kernel(torch, name: str, fn) -> None:
    """``fn`` runs exactly one device kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    check(names, f"the profiler recorded no device kernel for {name}")
    check(sum(n for _, n in names) == 1, f"{name} ran {names}")
    print(f"{name}: one device kernel a call ({names[0][0][:60]})")


def on_two_streams(torch, name: str, fn, inputs) -> None:
    """``fn(x)`` for each x of ``inputs``, called 20 times on a side stream
    of its own, the streams at once, gives the bits of the calls made in
    order on the default stream."""
    wants = [fn(x) for x in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    outs = []
    for stream, x in zip(streams, inputs):
        with torch.cuda.stream(stream):
            for _ in range(20):
                res = fn(x)
            outs.append(res)
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} on two streams differs from the calls in order")
    print(f"{name}: {len(inputs)} side streams x 20 calls at once == the calls in order, bitwise",
          flush=True)


def cohort_checks(torch, fwa, gen, g, w, lam) -> None:
    """Kernels 2-5 at their path shapes: one device kernel a call (each
    ticket counter sums the blocks' partials in the same launch), and
    kernels 2-4 called on two side streams at once, each stream with its
    own counter, equal the calls made in order."""
    from repro_torch.kernels import sharded_waterfill as swf

    dev = g.device
    q, scales = fwa.quantize_stacked(torch.randn(50, 114688, generator=gen, device=dev))
    w50 = torch.rand(50, generator=gen, device=dev)
    lam50 = torch.rand(50, generator=gen, device=dev)
    scores = torch.sort(torch.empty(1_000_000, device=dev).exponential_(generator=gen)).values
    levels = torch.exp2(torch.linspace(-12.0, 6.0, 128, device=dev))
    floors = levels * 0.01
    one_device_kernel(torch, "fused_cohort_agg_and_error",
                      lambda: fwa.fused_cohort_agg_and_error(g, w, lam))
    one_device_kernel(torch, "fused_weighted_agg", lambda: fwa.fused_weighted_agg(g, w))
    one_device_kernel(torch, "fused_dequant_cohort_agg",
                      lambda: fwa.fused_dequant_cohort_agg(q, scales, w50, lam50))
    one_device_kernel(torch, "waterfill_level_stats",
                      lambda: swf.waterfill_level_stats(scores, levels, floors))
    weights = (w, w.flip(0).contiguous())
    on_two_streams(torch, "fused_cohort_agg_and_error",
                   lambda ww: fwa.fused_cohort_agg_and_error(g, ww, lam), weights)
    on_two_streams(torch, "fused_weighted_agg", lambda ww: fwa.fused_weighted_agg(g, ww), weights)
    on_two_streams(torch, "fused_dequant_cohort_agg",
                   lambda ww: fwa.fused_dequant_cohort_agg(q, scales, ww, lam50),
                   (w50, w50.flip(0).contiguous()))


def dequant_kernel_phase(torch, fwa, ref, gen, flush, max_err):
    """Kernel 4 in int8 and fp8 at the compressed path's shapes, a vector-
    unaligned scale block, and a large shape where HBM should bind."""
    dev = torch.device("cuda")
    shapes = [  # (label, C, D_pad, scale block)
        ("oracle tiny_lm", 50, 114688, 128),
        ("deployable tiny_lm", 10, 114688, 128),
        ("oracle logreg", 100, 640, 128),
        ("unaligned", 3, 1000, 40),
        ("large", 20, 2**24, 128),
    ]
    rows = {}
    for label, c, d, sb in shapes:
        for qdtype in ("int8", "fp8"):
            q, scales = fwa.quantize_stacked(
                torch.randn(c, d, generator=gen, device=dev), dtype=qdtype, scale_block=sb
            )
            w2 = torch.rand(2, c, generator=gen, device=dev)
            w, lam = w2[0].contiguous(), (0.1 * w2[1]).contiguous()
            got = fwa.fused_dequant_cohort_agg(q, scales, w, lam)
            want = ref.dequant_cohort_agg_reference(q, scales, w, lam)
            again = fwa.fused_dequant_cohort_agg(q, scales, w, lam)
            torch.cuda.synchronize()
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=0.0)
            torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
            check(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
                  "fused_dequant_cohort_agg err / norms are not repeatable")
            err = float((got[0] - want[0]).abs().max())
            max_err["fused_dequant_cohort_agg"] = max(max_err["fused_dequant_cohort_agg"], err)
            nb = scales.shape[1]
            n_bytes = c * d + c * nb * 4 + 2 * c * 4 + (d + 1 + c) * 4
            # Per element: the scale multiply and three FMAs; then the error
            # row's square.  The widening itself is not counted as a flop.
            flops = 7 * c * d + 2 * d
            row = measure(torch, flush, lambda: fwa.fused_dequant_cohort_agg(q, scales, w, lam),
                          lambda: ref.dequant_cohort_agg_reference(q, scales, w, lam),
                          None, n_bytes, flops, err)
            row["shape"] = {"C": c, "D_pad": d, "scale_block": sb, "dtype": qdtype}
            rows[("fused_dequant_cohort_agg", label, qdtype)] = row
            report("fused_dequant_cohort_agg", f"{label} C={c} D_pad={d} sb={sb} {qdtype}", row,
                   "n/a (no library call takes per-block scales)",
                   f" bytes_bound_share={n_bytes / HBM_BYTES_PER_S * 1e3 / row['kernel_ms']:.1%}"
                   f" err_scalar_rel={float((got[1] - want[1]).abs() / want[1].abs()):.3g}"
                   f" norms_rel={float(((got[2] - want[2]).abs() / want[2].abs()).max()):.3g}")
            del q, scales, got, want, again
    # What binds kernel 4 at scale: the same work at a size that fits in the
    # 50 MB L2, timed with the cache flushed (from HBM) and warm (from L2).
    # Equal rates mean the SMs, not HBM, set the pace; int8 against fp8
    # (16 against 24 conversions per 16 codes) tells whether the widening does.
    c, d = 20, 2**20

    def warm():  # keeps the stream busy, as the flush does, without a memory pass
        torch.cuda._sleep(1_000_000)  # ~0.5 ms at the SM clock

    for qdtype in ("int8", "fp8"):
        q, scales = fwa.quantize_stacked(torch.randn(c, d, generator=gen, device=dev), dtype=qdtype)
        w, lam = torch.rand(c, device=dev), torch.zeros(c, device=dev)
        n_bytes = c * d + scales.numel() * 4 + (d + 1 + c) * 4
        run = lambda: fwa.fused_dequant_cohort_agg(q, scales, w, lam)  # noqa: E731
        cold, hot = time_ms(torch, run, flush), time_ms(torch, run, warm)
        print(f"fused_dequant_cohort_agg binding probe C={c} D_pad={d} {qdtype}: "
              f"from HBM {cold:.5f} ms ({n_bytes / cold / 1e6:.0f} GB/s, "
              f"{n_bytes / cold * 1e3 / HBM_BYTES_PER_S:.1%} of the HBM rate), "
              f"from L2 {hot:.5f} ms ({n_bytes / hot / 1e6:.0f} GB/s)", flush=True)
        del q, scales
    return rows


def waterfill_kernel_phase(torch, gen, flush, max_err, floor_ms):
    """Kernel 5 at the sharded solve's shapes: the 128-level ladder over
    sorted scores, as ``core/solver.py`` passes them (M = 10^6 is the path
    row; 10^5, 10^4 and the logreg spec's N = 100 the solve's other sizes),
    then M = 10^6 shuffled (the kernel sorts each chunk) and a ragged M with
    +inf entries and L = 100.  Counts exactly equal, mid_sum at rtol 1e-5,
    bitwise repeatable.  The bound is the bytes: M scores and 5 L-vectors
    (levels, floors, the three outputs).  The report also prints the
    compare-all algorithm's operations (two compares a pair and the adds
    the data needs; the first design's work) and the timing floor."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sharded_waterfill as swf

    dev = torch.device("cuda")
    rows = {}
    for label, m, n_levels in (("path", 1_000_000, 128), ("solve N=1e5", 100_000, 128),
                               ("solve N=1e4", 10_000, 128), ("logreg N", 100, 128),
                               ("shuffled", 1_000_000, 128), ("ragged +inf", 1_000_003, 100)):
        scores = torch.empty(m, device=dev).exponential_(generator=gen)
        if label == "ragged +inf":
            scores[torch.randperm(m, device=dev, generator=gen)[: m // 10]] = float("inf")
        elif label != "shuffled":
            scores = torch.sort(scores).values
        # A ladder spanning the scores, as the solve's first pass does.
        levels = torch.exp2(torch.linspace(-12.0, 6.0, n_levels, device=dev))
        floors = levels * 0.01
        got = torch.stack(swf.waterfill_level_stats(scores, levels, floors))
        again = torch.stack(swf.waterfill_level_stats(scores, levels, floors))
        want = torch.stack(ref.waterfill_stats_reference(scores, levels, floors))
        torch.cuda.synchronize()
        check(torch.equal(got[:2], want[:2]), f"waterfill_level_stats {label}: counts differ")
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0.0)
        check(torch.equal(got, again), f"waterfill_level_stats {label}: not repeatable")
        if label == "ragged +inf":
            check(float(got[0].max()) <= m - m // 10, "+inf scores were counted")
        err = float((got[2] - want[2]).abs().max())
        max_err["waterfill_level_stats"] = max(max_err["waterfill_level_stats"], err)
        n_bytes = m * 4 + 5 * n_levels * 4
        compare_all_ops = 2 * m * n_levels + 2 * int(got[0].sum())
        row = measure(torch, flush, lambda: swf.waterfill_level_stats(scores, levels, floors),
                      lambda: ref.waterfill_stats_reference(scores, levels, floors),
                      None, n_bytes, 0, err)
        row["shape"] = {"M": m, "L": n_levels, "sorted": label not in ("shuffled", "ragged +inf")}
        rows[("waterfill_level_stats", label, "float32")] = row
        rel = float(((got[2] - want[2]).abs() / want[2].abs().clamp(min=1e-30)).max())
        report("waterfill_level_stats", f"{label} M={m} L={n_levels}", row,
               "n/a (no one PyTorch call computes the three statistics)",
               f" mid_sum_rel={rel:.3g} compare_all_ops={compare_all_ops:.3g} "
               f"(at the f32 rate {compare_all_ops / F32_FLOPS_PER_S * 1e3:.5f} ms) "
               f"timing_floor_ms={floor_ms:.5f}")
        del scores, got, again, want
    return rows


def rmsnorm_kernel_phase(torch, gen, flush, max_err):
    """Kernel 6 at the serving path's shapes: (k)'s prefill (B*S, d_model)
    and decode (B, d_model), per-head rows of width hd (qk_norm's shape),
    (l)'s prefill at d_model 4608, (m)'s prefill at d_model 2048 and its
    Mamba2 gated norm over d_in 4096, qwen3's q norm at (w)'s prefill
    (8 x 512 x 64 rows of hd 128) and its block norms at (w)'s decode
    (d_model 4096; its prefill's are zamba2's gated-norm shape), arctic's
    block norms at (x)'s prefill and decode (d_model 7168), xLSTM's block
    and sLSTM norms at (y)'s prefill and decode (d_model 768) and its
    mLSTM inner norm at (y)'s decode and at an xlstm-125m round's width
    (d_in 1536, 8 clients x 2 x 64 rows), the vlm's block norms at (ad)'s prefill
    (d_model 4096), whisper's encoder norms at (ac)'s prefill (8 x 1500
    frames of 768), and a ragged D that takes the scalar loads;
    bf16 and f32.  The bound counts x read and y written once and
    ~4 f32 operations an element; the library call is ``F.rms_norm`` with
    weight 1 + scale."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    rows = {}
    for label, r, d in (("prefill smollm", 4096, 960), ("decode smollm", 8, 960),
                        ("qk_norm rows", 61440, 64), ("prefill gemma2", 4096, 4608),
                        ("prefill zamba2", 4096, 2048), ("gated norm zamba2", 4096, 4096),
                        ("q_norm qwen3", 262144, 128), ("decode qwen3", 8, 4096),
                        ("prefill arctic", 4096, 7168), ("decode arctic", 8, 7168),
                        ("prefill xlstm", 1024, 768), ("decode xlstm", 8, 768),
                        ("decode xlstm inner norm", 8, 1536), ("round xlstm inner norm", 1024, 1536),
                        ("prefill vlm", 4096, 4096), ("encoder whisper", 12000, 768),
                        ("ragged D", 4097, 962)):
        for dtype in (torch.bfloat16, torch.float32):
            tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
            x = torch.randn(r, d, generator=gen, device=dev).to(dtype)
            scale = (0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
            got = rms.rmsnorm(x, scale)
            want = ref.rmsnorm_reference(x, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            err = float((got.float() - want.float()).abs().max())
            max_err["rmsnorm"] = max(max_err["rmsnorm"], err)
            weight = (1.0 + scale.float()).to(dtype)
            ops, n_bytes = rms.work(x, scale)
            row = measure(torch, flush, lambda: rms.rmsnorm(x, scale),
                          lambda: ref.rmsnorm_reference(x, scale),
                          lambda: F.rms_norm(x, (d,), weight, 1e-6), n_bytes, ops, err)
            row["shape"] = {"R": r, "D": d, "dtype": str(dtype)[6:]}
            rows[("rmsnorm", label, str(dtype)[6:])] = row
            report("rmsnorm", f"{label} R={r} D={d} {str(dtype)[6:]}", row, "n/a",
                   " library=F.rms_norm(weight=1+scale)")
            del x, got, want
    # What a host-bound decode step pays a call: the wrapper (no gradient
    # needed, so the Function's forward) against torch.autograd.Function.apply.
    x = torch.randn(8, 960, generator=gen, device=dev).bfloat16()
    scale = torch.zeros(960, dtype=torch.bfloat16, device=dev)
    direct = host_us(torch, lambda: rms.rmsnorm(x, scale))
    applied = host_us(torch, lambda: rms._RMSNorm.apply(x, scale, 1e-6))
    print(f"rmsnorm decode smollm R=8 D=960 bfloat16 host time a call: {direct:.2f} us through "
          f"the wrapper, {applied:.2f} us through torch.autograd.Function.apply", flush=True)
    return rows


def host_us(torch, fn, calls: int = 2000) -> float:
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


def bf16_out_tol(want) -> dict:
    """The bf16 tolerance of a bidirectional or cross row: 4 bf16 ulps of the
    largest |output|, no relative term.  Both sides round the same bf16
    inputs' f32 result to bf16 (half an ulp each), and the kernel rounds
    its probabilities to bf16 for P.V (2^-9 of each weight, averaging out
    over the keys), so they differ by an ulp or two; a non-causal output
    averages many keys and stays far below 1, where 2e-2 would pass a
    dropped key tile."""
    top = float(want.float().abs().max())
    return dict(rtol=0.0, atol=4 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7))


def planted_tail(torch, gen, b, kv, g, s_q, s_k, hd, dtype, dev):
    """q, k, v (B, heads, S, hd) whose softmax puts nearly every query's
    mass on the last ``S_k mod 64`` keys, the ragged tail tile: q leans on
    a direction u of its KV head (|u|^2 = hd), the keys before the tail on
    -1.5 u (logits near -1.5 sqrt(hd)), the tail's keys are small noise
    (logits near 0).  A kernel that drops the tail, or lets its tile's
    padded keys into the softmax, misses the output by about |v|."""
    tail = s_k % 64 or 64
    u = torch.randn(b, kv, 1, hd, generator=gen, device=dev)
    u = u * (hd ** 0.5 / u.norm(dim=-1, keepdim=True))
    q = u.repeat_interleave(g, dim=1) + 0.1 * torch.randn(b, kv * g, s_q, hd, generator=gen, device=dev)
    k = -1.5 * u + 0.1 * torch.randn(b, kv, s_k, hd, generator=gen, device=dev)
    k[:, :, s_k - tail:] = 0.1 * torch.randn(b, kv, tail, hd, generator=gen, device=dev)
    v = torch.randn(b, kv, s_k, hd, generator=gen, device=dev)
    return tail, *(t.to(dtype) for t in (q, k, v))


def flash_planted_tail(torch, gen, label, case, dtype, tol, max_err) -> None:
    """Kernel 7 on ``planted_tail``'s input, held to its plain version:
    checks that the tail holds at least 99% of every query's mass, and
    prints what a kernel dropping the tail would be off by."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, kv, g, s, s_k, hd = case
    dev = torch.device("cuda")
    tail, q, k, v = planted_tail(torch, gen, b, kv, g, s, s_k, hd, dtype, dev)
    got = fa.flash_attention(q, k, v, causal=False, q_groups=g)
    want = ref.mha_reference(q, k, v, causal=False, q_groups=g)
    scores = q.float() @ k.float().repeat_interleave(g, dim=1).transpose(-1, -2) * hd ** -0.5
    mass = float(torch.softmax(scores, dim=-1)[..., s_k - tail:].sum(-1).min())
    del scores
    check(mass >= 0.99, f"flash_attention {label} planted tail: the tail holds {mass:.4f}")
    if dtype == torch.bfloat16:
        tol = bf16_out_tol(want)
    torch.testing.assert_close(got, want, **tol)
    err = float((got.float() - want.float()).abs().max())
    max_err["flash_attention"] = max(max_err["flash_attention"], err)
    cut = s_k - tail
    dropped = ref.mha_reference(q, k[:, :, :cut], v[:, :, :cut], causal=False, q_groups=g)
    drop_err = float((dropped.float() - want.float()).abs().max())
    check(drop_err > 10 * max(tol["atol"], err), f"flash_attention {label} planted tail: "
          f"dropping the tail moves the output only {drop_err:.3g}")
    print(f"flash_attention {label} {str(dtype)[6:]} planted tail (the last {tail} of {s_k} keys "
          f"hold >= {mass:.4f} of every query's mass): max_abs_err={err:.3g} atol={tol['atol']:.3g} "
          f"rtol={tol['rtol']:.3g}; dropping the tail would move it {drop_err:.3g}", flush=True)
    del q, k, v, got, want, dropped


def flash_kernel_phase(torch, gen, flush, max_err):
    """Kernel 7 at (k)'s prefill shape (B=8, 15 heads over 5 KV heads, S=512,
    hd=64) in all four modes (causal, window 96, full, softcap 30), at a
    ragged S=200, at (l)'s gemma2 shapes (32 heads over 16, hd=128,
    softcap 50, window 4096 and global), at (m)'s shared attention (32
    heads over 32, hd=64, causal) and at (w)'s and (x)'s prefill (qwen3: 64
    heads over 4, groups of 16; arctic: 56 over 8, groups of 7; hd=128,
    causal), and at (ac)'s and (ad)'s frontend shapes, bidirectional:
    whisper's encoder (12 heads, S=1500, hd=64), its cross-attention (64
    queries over 1500 frames) and the vlm's (32 heads over 8, 512 queries
    over 1601 patches, hd=128), S_k ragged against the 64-key tiles; bf16
    and f32; bf16 bidirectional and cross rows are held to 4 bf16 ulps of
    their largest output (``bf16_out_tol``), and the ragged ones also on
    ``planted_tail``'s input.  Each row names the kernel
    that ran, from the launch counters: the tensor cores for bf16 (hd 64
    and 128 here), the CUDA cores for f32.  q, k, v are the (B, S, heads, hd) projections
    seen as (B, heads, S, hd), as the model passes them.  The bound: q, k,
    v read and out written once over the memory rate, against 4 * hd
    operations per unmasked (query, key) pair of this input over the bf16
    tensor-core (or f32) peak.  The library call:
    ``F.scaled_dot_product_attention`` on K/V expanded over the groups (a
    boolean mask for the window; none for the softcap, which it lacks)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rows = {}
    cases = [  # (label, B, KV heads, groups, S_q, S_k, hd, causal, window, softcap)
        ("prefill smollm causal", 8, 5, 3, 512, 512, 64, True, None, None),
        ("prefill smollm window", 8, 5, 3, 512, 512, 64, True, 96, None),
        ("prefill smollm full", 8, 5, 3, 512, 512, 64, False, None, None),
        ("prefill smollm softcap", 8, 5, 3, 512, 512, 64, True, None, 30.0),
        ("ragged S smollm", 8, 5, 3, 200, 200, 64, True, None, None),
        ("prefill gemma2 local", 8, 16, 2, 512, 512, 128, True, 4096, 50.0),
        ("prefill gemma2 global", 8, 16, 2, 512, 512, 128, True, None, 50.0),
        ("prefill zamba2 shared", 8, 32, 1, 512, 512, 64, True, None, None),
        ("prefill qwen3", 8, 4, 16, 512, 512, 128, True, None, None),
        ("prefill arctic", 8, 8, 7, 512, 512, 128, True, None, None),
        ("encoder whisper", 8, 12, 1, 1500, 1500, 64, False, None, None),
        ("cross whisper", 8, 12, 1, 64, 1500, 64, False, None, None),
        ("cross vlm", 8, 8, 4, 512, 1601, 128, False, None, None),
    ]
    for label, b, kv, g, s, s_k, hd, causal, window, cap in cases:
        h = kv * g
        for dtype in (torch.bfloat16, torch.float32):
            tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-4, atol=2e-5)
            q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype).transpose(1, 2)
            k = torch.randn(b, s_k, kv, hd, generator=gen, device=dev).to(dtype).transpose(1, 2)
            v = torch.randn(b, s_k, kv, hd, generator=gen, device=dev).to(dtype).transpose(1, 2)
            kw = dict(causal=causal, window=window, softcap=cap, q_groups=g)
            tc_before = fa.flash_attention.launches_tc
            got = fa.flash_attention(q, k, v, **kw)
            tc = fa.flash_attention.launches_tc - tc_before == 1
            check(tc == fa.uses_tensor_cores(dtype, hd),
                  f"flash_attention {label} {dtype}: tensor-core launch {tc}")
            path = "tensor cores" if tc else "CUDA cores"
            want = ref.mha_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            if dtype == torch.bfloat16 and not causal:
                tol = bf16_out_tol(want)
            torch.testing.assert_close(got, want, **tol)
            err = float((got.float() - want.float()).abs().max())
            max_err["flash_attention"] = max(max_err["flash_attention"], err)
            if not causal and s_k % 64:
                flash_planted_tail(torch, gen, label, (b, kv, g, s, s_k, hd), dtype, tol, max_err)
            lib = None
            if cap is None:
                k_x, v_x = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
                if window is None:
                    lib = lambda: F.scaled_dot_product_attention(q, k_x, v_x, is_causal=causal)  # noqa: E731
                else:
                    pos = torch.arange(s, device=dev)
                    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                    lib = lambda: F.scaled_dot_product_attention(q, k_x, v_x, attn_mask=mask)  # noqa: E731
            pairs = fa.attention_pairs(s, s_k, causal, window)
            ops, n_bytes = fa.work(q, k, causal, window)
            row = measure(torch, flush, lambda: fa.flash_attention(q, k, v, **kw),
                          lambda: ref.mha_reference(q, k, v, **kw), lib, n_bytes, ops, err,
                          BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
            row["shape"] = {"B": b, "H": h, "q_groups": g, "S": s, "S_k": s_k, "hd": hd,
                            "window": window, "softcap": cap, "dtype": str(dtype)[6:]}
            row["path"] = path
            rows[("flash_attention", label, str(dtype)[6:])] = row
            ratio = f" kernel/library={row['kernel_ms'] / row['library_ms']:.2f}x" if lib else ""
            report("flash_attention",
                   f"{label} B={b} H={h} G={g} S={s}{'' if s_k == s else f' S_k={s_k}'} hd={hd} "
                   f"{str(dtype)[6:]}",
                   row, "n/a (no library call applies a softcap)",
                   f" path={path} pairs={pairs}{ratio} library=sdpa(K/V expanded)")
            del q, k, v, got, want
    return rows


def ssd_kernel_phase(torch, gen, flush, max_err):
    """Kernel 8 at (m)'s prefill shape (B=8, 64 heads, S=512, hd=N=64,
    Q=128) as ``models/ssm.py`` passes it: x and da f32 (B, H, S, ·) views of
    the model's (B, S, H, ·) tensors, b and c bf16 (B, S, N) slices of the
    conv output shared by the 64 heads, the final state returned; the same
    with bf16 x, with b and c repeated per row, at a ragged S=200, at
    hd=128 over N=16, and under a strong decay (-0.75 a step: exp(cum_t -
    cum_s) above the diagonal overflows f32).  Decays are the model's at
    its init (A=-1, da = -softplus(dt)).  y and the state within 1e-4 of the
    plain version relative to their largest value in f32, 3e-2 in bf16; the
    ragged and strong-decay cases also against the sequential recurrence
    ``ref.ssd_reference`` (1e-3 in f32, the tests' tolerance for a chunked
    sum against a step-by-step one; 3e-2 in bf16).  The bound: x, da, b, c
    read once, y and the state written once (``ssd_scan.work``), against
    ``ssd_scan.ssd_ops`` over the
    TF32 tensor-core rate (the units the kernel uses; the split's extra
    products are not counted as work); each row also prints the bound at
    the f32 rate off the tensor cores (the CUDA-core kernel's).  No PyTorch call computes
    the scan."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}
    cases = [  # (label, B, H, S, hd, N, Q, x dtype, b/c dtype, b/c shared, constant da)
        ("prefill zamba2", 8, 64, 512, 64, 64, 128, f32, bf16, True, None),
        ("prefill zamba2 bf16 x", 8, 64, 512, 64, 64, 128, bf16, bf16, True, None),
        # (ma5)'s prefill on a rank of (1, 2): the state rule's 32 of the 64 heads.
        ("prefill zamba2 heads of a rank", 8, 32, 512, 64, 64, 128, f32, bf16, True, None),
        ("per-row b/c", 8, 64, 512, 64, 64, 128, f32, f32, False, None),
        ("ragged S=200", 8, 64, 200, 64, 64, 128, f32, bf16, True, None),
        ("ragged S=200 bf16", 8, 64, 200, 64, 64, 128, bf16, bf16, True, None),
        ("hd=128 N=16", 4, 8, 128, 128, 16, 128, f32, f32, True, None),
        ("strong decay", 8, 64, 512, 64, 64, 128, f32, bf16, True, -0.75),
    ]
    for label, b, h, s, hd, n, q, x_dt, bc_dt, shared, da_value in cases:
        x = (0.7 * torch.randn(b, s, h, hd, generator=gen, device=dev)).to(x_dt).transpose(1, 2)
        if da_value is None:
            da = -F.softplus(0.5 * torch.randn(b, s, h, generator=gen, device=dev)).transpose(1, 2)
        else:
            da = torch.full((b, s, h), da_value, device=dev).transpose(1, 2)
        xbc = (0.5 * torch.randn(b, s, 4096 + 2 * n, generator=gen, device=dev)).to(bc_dt)
        bm, cm = xbc[..., 4096 : 4096 + n], xbc[..., 4096 + n :]
        if not shared:
            x = x.reshape(b * h, s, hd)
            da = da.reshape(b * h, s)
            bm, cm = (t.repeat_interleave(h, dim=0) for t in (bm, cm))
        y, st = ssd.ssd_scan(x, da, bm, cm, chunk=q, return_state=True)
        y_want, st_want = ref.ssd_scan_reference(x, da, bm, cm, chunk=q, return_state=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()),
              f"ssd_scan {label}: non-finite output")
        limit = 3e-2 if x_dt == bf16 else 1e-4
        errs = []
        for got, want in ((y, y_want), (st, st_want)):
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            check(rel <= limit, f"ssd_scan {label}: error {err:.3g} is {rel:.3g} of the largest value")
            errs.append((err, rel))
        max_err["ssd_scan"] = max(max_err["ssd_scan"], errs[0][0], errs[1][0])
        oracle_txt = ""
        if s % q or da_value is not None:  # ragged and strong decay: the step-by-step recurrence too
            bh = b * h
            b_r, c_r = (t.repeat_interleave(bh // t.shape[0], dim=0) for t in (bm, cm))
            y_seq, st_seq = ref.ssd_reference(x.reshape(bh, s, hd), da.reshape(bh, s), b_r, c_r)
            tol = 3e-2 if x_dt == bf16 else 1e-3
            for what, got, want in (("y", y.reshape(bh, s, hd), y_seq), ("state", st, st_seq)):
                diff, mag = (got.float() - want.float()).abs(), want.float().abs()
                check(bool((diff <= tol + tol * mag).all()),
                      f"ssd_scan {label}: {what} differs from the sequential recurrence beyond {tol}")
                oracle_txt += f" {what}_err_vs_sequential={float(diff.max()):.3g}"
            del b_r, c_r, y_seq, st_seq
        ops, n_bytes = ssd.work(x, da, bm, q, True)
        row = measure(torch, flush, lambda: ssd.ssd_scan(x, da, bm, cm, chunk=q, return_state=True),
                      lambda: ref.ssd_scan_reference(x, da, bm, cm, chunk=q, return_state=True),
                      None, n_bytes, ops, errs[0][0], TF32_FLOPS_PER_S)
        bound_f32 = max(n_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        row["shape"] = {"B": b, "H": h, "S": s, "hd": hd, "N": n, "Q": q, "dtype": str(x_dt)[6:],
                        "bc_dtype": str(bc_dt)[6:], "bc_shared": shared}
        rows[("ssd_scan", label, str(x_dt)[6:])] = row
        report("ssd_scan", f"{label} B={b} H={h} S={s} hd={hd} N={n} Q={q} x {str(x_dt)[6:]} "
               f"b/c {str(bc_dt)[6:]}{' shared' if shared else ' per row'}", row,
               "n/a (no PyTorch call computes the SSD scan)",
               f" y_rel={errs[0][1]:.3g} state_rel={errs[1][1]:.3g} state_err={errs[1][0]:.3g}{oracle_txt}"
               f" bound_ms_f32_rate={bound_f32:.5f}")
        del x, da, xbc, bm, cm, y, st, y_want, st_want
    return rows


# -- 3b. ranks: the client axis over two processes -----------------------------

# (r1)-(r4): each spec runs once in this process (S = 1) and once on two
# ranks (mesh_shape (2, 1), gloo, both processes on the one card); counts
# and cohorts exactly, both ranks bitwise equal.  f32 runs hold every float
# to 1e-5 of its array's largest magnitude, the parameters of each leaf.
# The bf16 runs at full width hold their losses to 1e-3 and each parameter
# leaf's difference norm to 5e-2 of its norm: a client's update is
# x0 - xR in bf16, where an update below a weight's bf16 step rounds to
# zero or one step, so two runs whose GEMMs round differently (a vmap of 2
# slots against one of 4) differ by whole steps of their smallest updates
# (on an H100: (r3)'s worst leaf 1.8e-2, (r4)'s 5.5e-3).  Each also
# runs in f32 ((r3') two layers at full width, (r4') reduced), held to
# 1e-5.  (r2) with int8 deltas and error feedback: the int8 codes of a
# round's aggregate (the async ring) and of its deltas flip where the
# reduced sums, added in another order, sit at a rounding boundary, and a
# flipped code moves its entry by a quantization step; its losses are held
# to 1e-3 and its parameter gap is printed beside the ring's flipped codes,
# not gated.  (r2') is (r2) without compression, at 1e-5.
RANKS = 2
RANKS_TIMEOUT_S = 600
RANKS_SAMPLE = 1 << 20  # parameter entries compared a leaf (a strided sample past that)
F32_TOL, BF16_TOL, INT8_TOL = ("f32", 1e-5, 1e-5), ("bf16", 1e-3, 5e-2), ("int8", 1e-3, None)
SMALL_GEMMA = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                   head_dim=64)


def ranks_specs(api) -> list:
    """(label, spec, (kind, float tolerance, parameter tolerance)) of the
    ranks phase."""
    from argparse import Namespace

    from repro_torch.examples import femnist_style

    lm_deploy = dict((label, spec) for label, spec, _ in path_specs(api))["tiny_lm deployable"]
    h = faulted_lm(api, lm_deploy)
    smollm = zoo_spec(api, "smollm-360m", rounds=2, clients=32, budget=6, cohort=4)
    gemma = zoo_spec(api, "gemma2-27b", kwargs=GEMMA_PATTERN, rounds=1, clients=32, budget=3,
                     cohort=1, federation={"local_steps": 1})
    return [
        ("(r1) femnist v1 oracle kvib", femnist_style.spec_for(Namespace(rounds=ROUNDS), "v1",
                                                              "kvib"), F32_TOL),
        ("(r2) tiny_lm deployable markov+deadline+async int8+EF",
         with_sections(api, h, compression={"delta_dtype": "int8"}), INT8_TOL),
        ("(r2') (r2) uncompressed", h, F32_TOL),
        ("(r3) smollm-360m client_parallel C=4", smollm, BF16_TOL),
        ("(r3') smollm-360m 2 layers f32", zoo_spec(
            api, "smollm-360m", rounds=2, clients=32, budget=6, cohort=4, kwargs=AGREE_KW),
         F32_TOL),
        ("(r4) gemma2-27b one pattern cohort_sequential C=1", gemma, BF16_TOL),
        ("(r4') gemma2-27b reduced f32, local batch 3", zoo_spec(
            api, "gemma2-27b", kwargs=SMALL_GEMMA, rounds=2, clients=32, budget=3, cohort=2,
            federation={"batch_size": 3}), F32_TOL),
    ]


def ranks_launches(cfg, spec, ranks: int) -> dict:
    """Kernel launches of one run of ``spec`` on each of ``ranks`` ranks:
    the task round's aggregation kernel (kernel 1 oracle, and deployable
    over S > 1 ranks, whose error norm is taken after the reduce; kernel 2
    deployable on one; kernel 4 compressed, twice a round over S > 1), kernel 5's five ladder passes per
    split solve (the sampler's, and the regret's optimum in oracle mode),
    the zoo round's kernels 6-7 on the rank's slots (client_parallel) or
    every slot (cohort_sequential) and kernel 2 once a round on the rank's
    slots (client_parallel, S > 1)."""
    t = spec.federation.rounds
    split = ranks > 1
    # The sampler's solve runs the ladder when it is split or sampler_axis is
    # set; the regret's optimum (oracle task runs) only when split.
    oracle = spec.task.kind == "task" and spec.execution.oracle_metrics
    solves = int(split or spec.execution.sampler_axis is not None) + int(split and oracle)
    want = {"waterfill_level_stats": LADDER_PASSES * t * solves}
    if spec.task.kind == "task":
        if spec.compression.enabled:
            want["fused_dequant_cohort_agg"] = t * (2 if split else 1)
        elif spec.execution.oracle_metrics or split:  # kernel 1's rows w and w - lam over S > 1
            want["fused_multi_weighted_agg"] = t
        else:
            want["fused_cohort_agg_and_error"] = t
        return want
    c = spec.federation.cohort
    if cfg.round_mode == "client_parallel":
        c = -(-c // ranks)
        want["fused_cohort_agg_and_error"] = t if split else 0
    per_round = zoo_launches_per_round(cfg, c, spec.federation.local_steps)
    want.update({k: t * v for k, v in per_round.items()})
    return want


def ranks_run(torch, spec) -> dict:
    """One run of ``spec`` on this process through ``api.run`` (the card):
    History and final parameters as numpy, kernel launches, collectives,
    the wall seconds, the peak bytes allocated, and the bytes of the (N,)
    leaves the run's last state holds (the sampler's, the Markov chain,
    the score history)."""
    import numpy as np

    import repro_torch.api.runner as runner_mod
    import repro_torch.fed.server as server_mod
    from repro_torch import api, kernels
    from repro_torch.launch import mesh

    states = []

    def spy(real):
        def run_segmented(*a, **k):
            states.append(real(*a, **k))
            return states[-1]
        return run_segmented

    saved = (runner_mod.run_segmented, server_mod.run_segmented)
    runner_mod.run_segmented = spy(saved[0])
    server_mod.run_segmented = spy(saved[1])
    try:
        built = api.build(spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        mesh.reset_collective_counts()
        t0 = time.perf_counter()
        hist = api.run(spec, built=built)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        runner_mod.run_segmented, server_mod.run_segmented = saved
    st = states[-1]
    n_leaves = [x for x in (st.sampler.stats, st.sampler.aux)]
    if isinstance(st.faults, dict) and "chain" in st.faults:
        n_leaves.append(st.faults["chain"])
    if "scores" in st.metrics:
        n_leaves.append(st.metrics["scores"])
    ring = st.faults.get("buf", {}) if isinstance(st.faults, dict) else {}
    out = {
        "loss": np.asarray(hist.train_loss, np.float64),
        "cohort": np.asarray(hist.cohort_size, np.int64),
        "dropped": np.asarray(hist.cohort_dropped, np.int64),
        "deadline_dropped": np.asarray(hist.deadline_dropped, np.int64),
        "sq_error": np.asarray(hist.estimator_sq_error, np.float64),
        "wall_s": np.asarray(wall),
        "peak_bytes": np.asarray(peak),
        "n_bytes": np.asarray(sum(x.numel() * x.element_size() for x in n_leaves)),
        "n_shapes": np.asarray([list(x.shape)[-1] for x in n_leaves]),
    }
    if ring.get("delta") is not None and ring["delta"].dtype == torch.int8:
        out["ring_codes"] = ring["delta"].to(torch.int16).cpu().numpy()
    if hist.regret is not None and hist.regret.costs:
        out["cost"] = np.asarray(hist.regret.costs, np.float64)
        out["opt_cost"] = np.asarray(hist.regret.opt_costs, np.float64)
    named = _named_leaves(hist.final_params)
    for i, (_, leaf) in enumerate(named):
        flat = np.asarray(leaf, np.float32).reshape(-1)
        # The same strided sample at S = 1 and S = 2: at most 2^20 entries a
        # leaf cross the processes (gemma2's one pattern holds 2.3e9).
        out[f"param_{i:04d}"] = flat[::-(-flat.size // RANKS_SAMPLE)]
    out["param_names"] = np.asarray([name for name, _ in named])
    counts = kernels.launch_counts()
    out["launch_names"] = np.asarray(sorted(counts))
    out["launches"] = np.asarray([counts[k] for k in sorted(counts)])
    coll = mesh.collective_counts()
    out["collective_names"] = np.asarray(sorted(coll))
    out["collectives"] = np.asarray([coll[k] for k in sorted(coll)])
    del hist, built, states
    runner_mod._DATASET_CACHE.clear()
    torch.cuda.empty_cache()
    return out


def ranks_worker(rank: int, port: int, specs_path: str, out_dir: str) -> int:
    """One rank of the ranks phase (``chip_smoke.py --ranks-worker``): joins
    the two-rank gloo group and runs every spec, each result an npz."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.examples import femnist_style  # noqa: F401  (registers "vision_like")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=RANKS,
                            rank=rank, timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        for i, d in enumerate(json.loads(Path(specs_path).read_text())):
            out = ranks_run(torch, api.ExperimentSpec.from_dict(d))
            np.savez(Path(out_dir) / f"run{i}_r{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


def _rel(a, b) -> float:
    import numpy as np

    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def ranks_phase(torch, card: str) -> dict:
    """Each of (r1)-(r4) at S = 1 here, then on two ranks
    (``execution.mesh_shape=(2, 1)``, gloo, two processes on the card):
    agreement, the kernels each rank launched, collectives a round, each
    rank's resident (N,) bytes, seconds a run both ways.  Returns the
    launches of the S = 2 runs, both ranks'."""
    phase("ranks")
    import socket
    import tempfile

    import numpy as np

    from repro_torch import api, kernels

    specs = ranks_specs(api)
    launches = {k: 0 for k in kernels.launch_counts()}
    ones = []
    for label, spec, _ in specs:
        ones.append(ranks_run(torch, spec))
        print(f"{label}: S=1 on the card {float(ones[-1]['wall_s']):.3f} s "
              f"({spec.federation.rounds} rounds)", flush=True)
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="ranks_"))
    split = [with_sections(api, spec, execution={"mesh_shape": [RANKS, 1]}).to_dict()
             for _, spec, _ in specs]
    (tmp / "specs.json").write_text(json.dumps(split))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ranks-worker", str(r), str(port),
         str(tmp / "specs.json"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(RANKS)]
    try:
        logs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"ranks: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    print(f"ranks: two processes over gloo on one card, {time.perf_counter() - t0:.1f} s "
          "from start to exit", flush=True)
    from repro_torch.api.runner import build as api_build

    failures = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failures.append(msg)
            print(f"FAILED: {msg}", flush=True)

    for i, ((label, spec, tols), one) in enumerate(zip(specs, ones)):
        res = [dict(np.load(tmp / f"run{i}_r{r}.npz")) for r in range(RANKS)]
        r0 = res[0]
        for k in r0:
            expect(np.array_equal(r0[k], res[1][k]) or
                   k in ("wall_s", "peak_bytes", "n_bytes", "n_shapes"),
                   f"{label}: the ranks differ in {k}")
        for k in ("cohort", "dropped", "deadline_dropped"):
            expect(np.array_equal(r0[k], one[k]), f"{label}: {k} {r0[k]} at S=2, {one[k]} at S=1")
        diffs = {k: _rel(r0[k], one[k]) for k in ("loss", "sq_error", "cost", "opt_cost")
                 if k in one}
        kind, f_tol, p_tol = tols
        keys = sorted(k for k in one if k.startswith("param_") and k != "param_names")
        if kind == "bf16":  # each leaf's difference norm over its norm
            gaps = [float(np.linalg.norm(r0[k] - one[k])) /
                    max(float(np.linalg.norm(one[k])), 1e-30) for k in keys]
        else:
            gaps = [_rel(r0[k], one[k]) for k in keys]
        worst = int(np.argmax(gaps))
        params = gaps[worst]
        differ = sum(int((r0[k] != one[k]).sum()) for k in keys)
        total = sum(one[k].size for k in keys)
        how = (f"{'difference norm over its norm' if kind == 'bf16' else 'of its largest entry'}"
               f" in {one['param_names'][worst]} (norm {float(np.linalg.norm(one[keys[worst]])):.3g})"
               f"; {differ} of {total} compared entries differ, at most {RANKS_SAMPLE} a leaf")
        for k, v in diffs.items():
            expect(v <= f_tol, f"{label}: {k} differs by {v:.3g} of its scale (tolerance {f_tol})")
        expect(p_tol is None or params <= p_tol,
               f"{label}: parameters differ by {params:.3g} (tolerance {p_tol})")
        flips = ""
        if "ring_codes" in one:
            delta = np.abs(r0["ring_codes"].astype(np.int32) - one["ring_codes"])
            flips = (f"; the async ring's int8 codes: {int((delta > 0).sum())} of {delta.size} "
                     f"differ, by at most {int(delta.max())}")
        cfg = api_build(spec).arch_config if spec.task.kind == "zoo" else None
        names = [str(k) for k in r0["launch_names"]]
        for r, rr in enumerate(res):
            got = {k: int(v) for k, v in zip(names, rr["launches"])}
            want = {k: 0 for k in names}
            want.update(ranks_launches(cfg, spec, RANKS))
            expect(got == want, f"{label}: rank {r} launched {got}, expected {want}")
            for k, v in got.items():
                launches[k] += v
        one_got = {str(k): int(v) for k, v in zip(one["launch_names"], one["launches"])}
        want1 = {k: 0 for k in one_got}
        want1.update(ranks_launches(cfg, spec, 1))
        expect(one_got == want1, f"{label}: S=1 launched {one_got}, expected {want1}")
        rounds = spec.federation.rounds
        coll = {str(k): int(v) / rounds for k, v in zip(r0["collective_names"], r0["collectives"])}
        print(f"{label}: S=2 against S=1, largest difference over its scale "
              f"{ {k: float(f'{v:.3g}') for k, v in diffs.items()} } params {params:.3g} "
              f"({how}); "
              f"cohorts {r0['cohort'].tolist()}; collectives a round {coll}; resident (N,) "
              f"bytes S=1 {int(one['n_bytes'])} rank 0 {int(r0['n_bytes'])} rank 1 "
              f"{int(res[1]['n_bytes'])} (rows {one['n_shapes'].tolist()} -> "
              f"{r0['n_shapes'].tolist()} / {res[1]['n_shapes'].tolist()}); wall s S=1 "
              f"{float(one['wall_s']):.3f} S=2 rank 0 {float(r0['wall_s']):.3f} rank 1 "
              f"{float(res[1]['wall_s']):.3f} (both ranks share the card: no speed-up); peak "
              f"bytes allocated S=1 {int(one['peak_bytes'])} rank 0 {int(r0['peak_bytes'])} "
              f"rank 1 {int(res[1]['peak_bytes'])}; "
              f"launches a rank { {k: v for k, v in got.items() if v} }{flips}; card: {card}",
              flush=True)
    check(not failures, "ranks: " + "; ".join(failures))
    return launches


# -- model axis ----------------------------------------------------------------

# The model axis on two processes over gloo on the card, mesh (1, 2), each
# case against one process unsplit: (ma1) smollm-360m whole, a prefill of
# 8 x 512 and one round step at (n)'s geometry (C = 8, R = 2, local batch 2,
# seq 64), under ``models.sharding.use_rules``; (ma2) qwen3-moe one layer at
# full width, a prefill of 8 x 512 with the dense dispatch and with the a2a,
# 64 of the 128 experts a process; (ma3) ``api.run`` of (r3)'s spec on the
# mesh (1, 2) against S = 1, bitwise (the model ranks replicate); (ma4) the
# dry run on the card's CPU: ``launch.dryrun --arch llama3-405b --shape
# train_4k --mesh 16,16`` and ``--multi-pod`` (CPU jobs beside the card's
# phases), and (ma1)'s prefill counted for one rank of (1, 2), its predicted
# peak held against each process's measured one.  bf16 gaps are a
# difference norm over the norm.
MA_MESH = (1, 2)
# (ma2)'s a2a runs at a capacity factor where neither dispatch drops a row
# (every expert's buffer holds all 4,096 tokens; the pair buffers all of a
# rank's rows), so that it and one process's dense dispatch compute the
# same function; at qwen3's 1.25 the two drop different rows (the a2a
# slots a rank's rows by wire order) and differ by a third of the logits'
# norm.  Its drops are held against the reference's a2a on the CPU
# (tests/test_torch_model_axis.py).
MA2_A2A_CF = 16.0
MA_SEED = 11
MA_ROUND = dict(cohort=8, local_steps=2, local_batch=2, seq=64)
# (ma1)'s round is held on its update: the round's f32 estimate d (kernel 2's
# output on a rank's blocks, gathered) against one process's, leaf by leaf,
# and kernel 2's d on each rank against ``weighted_delta_sum`` on that
# rank's own deltas.  A planted fault (``_NoMlpGradSum``: the MLP input's
# gradient left unsummed over ``model``) must move the update past its
# limit; the parameters after the step, mostly the initial weights, hide
# most of an update.  The update's limit sits between the sound gap (0.151
# on the largest leaf, 0.111 the median, on an H100 80GB HBM3 at 700 W) and
# the planted one (0.896): in bf16 a local step rounds the weights to their
# grid, and most of one round's change is under one ulp of a weight, so
# gradients summed in another order flip some of those roundings (in f32 at
# reduced width the split step holds the unsplit one to 1e-5,
# tests/test_torch_model_axis.py).  "ma1 round f32" is the same round with
# f32 weights (TF32 off in both), which tells whether that floor is bf16's:
# its update is held to 1e-4, f32 rounding summed in another order through
# the round.
MA_TOL = {"ma1 prefill": 3e-2, "ma1 round update": 0.3, "ma1 round norms": 3e-2,
          "ma1 round loss": 1e-2, "ma1 round kernel 2": 1e-5, "ma2 dense": 3e-2,
          "ma2 a2a": 3e-2, "ma1 round f32 update": 1e-4, "ma1 round f32 norms": 1e-4,
          "ma1 round f32 loss": 1e-5, "ma1 round f32 kernel 2": 1e-5}
MA_SAMPLE = 1 << 16  # entries compared a leaf (a strided sample past that)
MA_PLANTED = "ma1 round planted"


def ma_config(name: str):
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    if name == "ma1 round f32":
        return dataclasses.replace(get_config("smollm-360m"), param_dtype=torch.float32)
    if name.startswith("ma1"):
        return get_config("smollm-360m")
    arch, kw = FAMILY_RUNS["(z) qwen3-moe one layer"][:2]
    cfg = get_config(arch).reduced(**kw)
    if name == "ma2 a2a":
        return dataclasses.replace(cfg, moe_impl="a2a", capacity_factor=MA2_A2A_CF)
    return cfg


def ma_inputs(torch, name: str, cfg, gen):
    """The case's weights (whole) and inputs, from ``gen`` on the card."""
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    params = transformer.init_params(cfg, gen, dev)
    if name.startswith("ma1 round"):
        c, r, b, s = (MA_ROUND[k] for k in ("cohort", "local_steps", "local_batch", "seq"))
        tok = torch.randint(0, cfg.vocab, (c, r, b, s), device=dev, generator=gen)
        tgt = torch.randint(0, cfg.vocab, (c, r, b, s), device=dev, generator=gen)
        w = torch.rand((c,), device=dev, generator=gen) + 0.1
        return params, (tok, tgt, w)
    return params, (torch.randint(0, cfg.vocab, (8, 512), device=dev, generator=gen),)


def ma_fn(name: str, cfg):
    from repro_torch.fed.round import RoundSpec, build_round_step
    from repro_torch.models import transformer

    if name.startswith("ma1 round"):
        return build_round_step(cfg, RoundSpec(
            cohort=MA_ROUND["cohort"], local_steps=MA_ROUND["local_steps"],
            local_batch=MA_ROUND["local_batch"], local_lr=0.05))
    return lambda p, tok: transformer.prefill(p, cfg, tok)


def ma_sample(np, tree, prefix: str) -> dict:
    out = {}
    for i, (_, leaf) in enumerate(_named_leaves(tree)):
        flat = leaf.float().reshape(-1).cpu().numpy()
        out[f"{prefix}_{i:04d}"] = flat[::-(-flat.size // MA_SAMPLE)]
    return out


@contextlib.contextmanager
def ma_keep_estimate(keep: dict):
    """Record the round step's f32 estimate d in ``keep["d"]`` (and, on the
    split path, the deltas and weights kernel 2 took), changing nothing."""
    from repro_torch.core import estimator
    from repro_torch.fed import round as round_mod

    plain, split = round_mod.weighted_delta_sum, estimator.aggregate_cohort

    def plain_kept(deltas, w):
        keep["d"] = plain(deltas, w)
        return keep["d"]

    def split_kept(deltas, w, *, shard):
        keep.update(deltas=deltas, weights=w, d=split(deltas, w, shard=shard))
        return keep["d"]

    round_mod.weighted_delta_sum, estimator.aggregate_cohort = plain_kept, split_kept
    try:
        yield
    finally:
        round_mod.weighted_delta_sum, estimator.aggregate_cohort = plain, split


class _NoMlpGradSum:
    """``models/sharding`` as ``models/mlp.py`` sees it in (ma1)'s planted
    run: the MLP input's gradient is left unsummed over ``model``, so each
    rank's update misses the other rank's hidden units below every MLP."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    @staticmethod
    def reduce_grad(x, group):
        return x


def ma_case(torch, name: str, split: bool) -> dict:
    """One case of (ma1)/(ma2): unsplit here, or this rank's share under
    ``use_rules`` on ``MA_MESH``: the outputs as numpy, the kernels
    launched, the collectives, the peak bytes (allocated after the
    arguments, over the second of two calls, every cuBLAS workspace freed
    before it) and the seconds of that call."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.fed.cohort import weighted_delta_sum
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as lsh
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import sharding as msh

    cfg = ma_config(name)
    round_case = name.startswith("ma1 round")
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params, args = ma_inputs(torch, name, cfg, torch.Generator(device="cuda").manual_seed(MA_SEED))
    mesh, specs = None, None
    if split:
        mesh = mesh_mod.make_mesh(MA_MESH)
        specs = lsh.param_specs(params, mesh, False)
        params = lsh.param_shardings(params, mesh, False)
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    fn = ma_fn(name, cfg)
    keep: dict = {}
    ctx = contextlib.ExitStack()
    if split:
        rules = lsh.activation_rules(mesh, client_parallel=round_case)
        rules["batch"] = None  # the batch is whole on every model rank
        ctx.enter_context(msh.use_rules(mesh, rules))
    if round_case:
        ctx.enter_context(ma_keep_estimate(keep))
    if name == MA_PLANTED:
        mlp_mod.msh = _NoMlpGradSum(msh)
        ctx.callback(setattr, mlp_mod, "msh", msh)
    with ctx:
        # No warm-up for the a2a (its seconds are gloo's host staging), the
        # planted run or the f32 round (only their values are read).
        if name not in ("ma2 a2a", MA_PLANTED, "ma1 round f32"):
            out = fn(params, *args)  # warm-up
            torch.cuda.synchronize()
            del out
            keep.clear()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        mesh_mod.reset_collective_counts()
        t0 = time.perf_counter()
        out = fn(params, *args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    res = {"seconds": np.asarray(secs), "peak_bytes": np.asarray(peak - base),
           "held_bytes": np.asarray(held - base)}
    counts = kernels.launch_counts()
    res["launch_names"] = np.asarray(sorted(counts))
    res["launches"] = np.asarray([counts[k] for k in sorted(counts)])
    coll = mesh_mod.collective_counts()
    res["collective_names"] = np.asarray(sorted(coll))
    res["collectives"] = np.asarray([coll[k] for k in sorted(coll)])
    if round_case:
        new, norms, loss = out
        d = keep.pop("d")
        if split:
            # Kernel 2 at this rank's shape against its plain sum.
            want = weighted_delta_sum(keep.pop("deltas"), keep.pop("weights"))
            flat = [x.reshape(-1) for _, x in _named_leaves(d)]
            flat_want = [x.reshape(-1) for _, x in _named_leaves(want)]
            err = torch.stack([(a - b).abs().max() for a, b in zip(flat, flat_want)]).max()
            diff = sum(float((a - b).double().square().sum()) for a, b in zip(flat, flat_want))
            ref = sum(float(b.double().square().sum()) for b in flat_want)
            res["kernel2_gap"] = np.asarray(math.sqrt(diff / ref))
            res["kernel2_max_abs_err"] = np.asarray(float(err))
            res["kernel2_entries"] = np.asarray(sum(x.numel() for x in flat))
            del want, flat, flat_want
            blocks = [x.shape for _, x in _named_leaves(d)]
            new = lsh.gather_params(new, specs, mesh)
            d = lsh.gather_params(d, specs, mesh)
            res["split_leaf"] = np.asarray(
                [b != x.shape for b, (_, x) in zip(blocks, _named_leaves(d))])
        res.update(ma_sample(np, new, "param"))
        res.update(ma_sample(np, d, "update"))
        res["norms"], res["loss"] = norms.float().cpu().numpy(), loss.float().cpu().numpy()
        del d, new
    else:
        res["logits"] = out[0].float().cpu().numpy()
    del out, params, args
    torch.cuda.empty_cache()
    return res


MA_CASES = ("ma1 prefill", "ma1 round", "ma2 dense", "ma2 a2a", "ma1 round f32")


def model_axis_worker(rank: int, port: int, out_dir: str) -> int:
    """One rank of the model_axis phase (``chip_smoke.py --model-axis-worker``):
    joins the two-rank gloo group, runs (ma1)-(ma2) as its share and (ma3),
    each result an npz."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        for i, name in enumerate(MA_CASES + (MA_PLANTED,)):
            np.savez(Path(out_dir) / f"ma{i}_r{rank}.npz", **ma_case(torch, name, True))
        spec = dict((label, s) for label, s, _ in ranks_specs(api))[MA3_LABEL]
        spec = with_sections(api, spec, execution={"mesh_shape": list(MA_MESH)})
        np.savez(Path(out_dir) / f"run_r{rank}.npz", **ranks_run(torch, spec))
        for name in MA5:
            forced = np.load(Path(out_dir) / f"{ma5_slug(name)}_tokens.npy")
            np.savez(Path(out_dir) / f"{ma5_slug(name)}_r{rank}.npz",
                     **ma5_case(torch, name, True, forced))
            np.savez(Path(out_dir) / f"{ma5_slug(name)}_planted_r{rank}.npz",
                     **ma5_case(torch, name, True, forced, planted=True))
        spec = with_sections(api, ma6_spec(api), execution={"mesh_shape": [2, 1]})
        np.savez(Path(out_dir) / f"ma6_r{rank}.npz", **ranks_run(torch, spec))
    finally:
        dist.destroy_process_group()
    return 0


MA3_LABEL = "(r3) smollm-360m client_parallel C=4"
# (ma5): decode of recurrent caches split over ``model`` at MA_MESH, each
# arch whole: (m)'s prefill of 8 x 512 for zamba2-1.2b in bf16, xlstm-125m
# at prompts of 4 in bf16 and of 8 in f32, then MA5_STEPS decode steps.
# The mamba2 and mLSTM heads are computed on a rank's block (the ``state``
# rule: no weight or state leaf of theirs gathered; kernel 8 on 32 of
# zamba2's 64 heads in the prefill), the sLSTM gathered at use.  One
# process runs greedy; the ranks are fed its tokens, so each step's logits
# compare (difference norm over the norm, the largest over the steps), and
# their own greedy choices are counted.  Each rank's final recurrent state
# blocks (a strided sample of each leaf) against the blocks of one
# process's caches; the first step's collectives and the bytes the ranks'
# calls returned (``launch.mesh.collective_bytes``) against the count's,
# the bytes within MA5_BYTES (the heads' activations and partial sums, the
# shared attention's and the sLSTM's leaves gathered at use).
# The split rounds every mamba2 and mLSTM block's GEMMs in another order
# than one process does (column blocks of the projections, f32 partial
# products of the output projection), so a bf16 split run and one
# process's bf16 run are two bf16 roundings of one function.  Each is held
# against one process's f32 run of the same weights fed the same tokens
# (the anchor, "anchor" in MA5_TOL): the split's distance from it, in
# logits and state blocks, at most MA5_ANCHOR times one process's.  The f32
# case is held pairwise.  xlstm-125m at its random init is chaotic: one
# weight moved by one ulp in one process (``ulp_gap``, printed) moves its
# logits by O(1) over a prompt of 128 tokens, where the anchor could tell
# nothing apart, hence its short prompts.  Each case runs once more with a
# planted fault (``_NoPartialSum``: a decode step's partial sums over the
# state blocks left unreduced), which its check must reject.
MA5 = {"ma5 zamba2": ("zamba2-1.2b", 512, "bfloat16"), "ma5 xlstm": ("xlstm-125m", 4, "bfloat16"),
       "ma5 xlstm f32": ("xlstm-125m", 8, "float32")}
MA5_BATCH, MA5_STEPS = 8, 16
MA5_TOL = {"ma5 zamba2": "anchor", "ma5 xlstm": "anchor",
           "ma5 xlstm f32": {"logits": 1e-3, "state": 1e-3}}
MA5_ANCHOR = 1.5
MA5_BYTES = {"ma5 zamba2": 0.15e9, "ma5 xlstm": 0.1e9, "ma5 xlstm f32": 0.15e9}  # a step's, a rank


def ma5_slug(name: str) -> str:
    return name.replace(" ", "_")


def ma5_config(name: str):
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    arch, _, dtype = MA5[name]
    return dataclasses.replace(get_config(arch), param_dtype=getattr(torch, dtype))
# (ma6): a reduced qwen3 in f32, cohort_sequential, local batch 3 (rows
# split 2 / 1 over two ranks, mesh (2, 1)) at a capacity factor that drops
# pairs (3 x 64 tokens, top 2 of 8 experts: 24 rows an expert for the whole
# batch, 48 pairs an expert on average), through ``api.run`` against S = 1.
# The full-width round needs several cards: (z)'s one layer peaks at 58 GB
# in one process.
MA6_KW = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
              head_dim=64, n_experts=8, top_k=2, moe_d_ff=256, capacity_factor=0.5)


def ma6_spec(api):
    return zoo_spec(api, "qwen3-moe-235b-a22b", kwargs=MA6_KW, rounds=2, clients=32, budget=3,
                    cohort=2, federation={"batch_size": 3})


def ma5_layout(cfg, s: int):
    """(the mesh, each recurrent slot's one-repeat cache specs with the
    batch whole) of (ma5)'s caches at MA_MESH."""
    from repro_torch.launch import sharding as lsh
    from repro_torch.launch.mesh import batch_axes, make_mesh
    from repro_torch.models import transformer

    mesh = make_mesh(MA_MESH)
    max_seq = s + MA5_STEPS
    specs = lsh.cache_shardings(transformer.init_caches(cfg, MA5_BATCH, max_seq, device="meta"),
                                mesh, max_seq, MA5_BATCH)
    out = {}
    for j, kind in enumerate(cfg.block_pattern):
        if kind in transformer.STATE_KINDS:
            out[j] = {k: tuple(None if i == 1 and lsh.spec_axes(e) == batch_axes(mesh) else e
                               for i, e in enumerate(spec)) for k, spec in specs[j].items()}
    return mesh, out


class _NoPartialSum:
    """``models/sharding`` as ``models/ssm.py`` and ``models/xlstm.py`` see
    it in (ma5)'s planted runs: a decode step's partial sums over a state
    block (mamba2's y over N, the mLSTM's c q and n q over k) are left
    unreduced, so each rank's output misses the other rank's block."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    @staticmethod
    def all_reduce(x, group, op="sum"):
        return x


def ma5_case(torch, name: str, split: bool, forced=None, planted: bool = False) -> dict:
    """(ma5) ``name``: a prefill of MA5_BATCH prompts and MA5_STEPS decode
    steps, unsplit (greedy) or as this rank's share on MA_MESH (fed
    ``forced``, one process's tokens): every step's logits, the greedy
    tokens (B, 1 + steps), a strided sample of each recurrent cache leaf
    (this rank's block; unsplit, each rank's block of the whole), the
    first decode step's collectives and their result bytes, kernel
    launches, the peak bytes and the seconds; unsplit, for a case held to
    its anchor, the same weights in f32 fed the same tokens
    (``anchor_logits``, ``anchor_`` state samples), and ``ulp_gap``: the
    prefill's and each decode step's logits again, fed the same tokens,
    with one weight of the first block moved by one ulp, against the
    first.  ``planted``: the split run under
    ``_NoPartialSum``."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as lsh
    from repro_torch.models import sharding as msh
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer
    from repro_torch.models import xlstm as xlstm_mod

    arch, s, _ = MA5[name]
    cfg = ma5_config(name)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(MA_SEED)
    params = transformer.init_params(cfg, gen, dev)
    tok = torch.randint(0, cfg.vocab, (MA5_BATCH, s), device=dev, generator=gen)
    max_seq = s + MA5_STEPS
    ctx, kw = contextlib.ExitStack(), {}
    mesh, layout = ma5_layout(cfg, s)
    if split:
        params = lsh.param_shardings(params, mesh, False)
        torch.cuda.empty_cache()
        rules = lsh.activation_rules(mesh)
        rules["batch"] = None  # every rank holds every row
        ctx.enter_context(msh.use_rules(mesh, rules))
        kw = {"max_seq": max_seq, "batch": MA5_BATCH}
    if planted:
        for mod in (ssm_mod, xlstm_mod):
            mod.msh = _NoPartialSum(msh)
            ctx.callback(setattr, mod, "msh", msh)
    kernels.reset_launch_counts()
    res = {}
    with ctx, torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(params, cfg, tok, max_seq=max_seq,
                                             **({"batch": MA5_BATCH} if split else {}))
        torch.cuda.synchronize()
        res["prefill_s"] = np.asarray(time.perf_counter() - t0)
        first = logits.float()
        greedy, steps = [logits.argmax(-1)], []
        t0 = time.perf_counter()
        for i in range(MA5_STEPS):
            fed = greedy[-1] if forced is None else torch.as_tensor(forced[:, i:i + 1], device=dev)
            if i == 0:
                mesh_mod.reset_collective_counts()
            logits, caches = transformer.decode_step(params, cfg, fed, caches, s + i, **kw)
            if i == 0:
                coll, sent = mesh_mod.collective_counts(), mesh_mod.collective_bytes()
            steps.append(logits[:, -1].float())
            greedy.append(logits.argmax(-1))
        torch.cuda.synchronize()
        res["decode_s"] = np.asarray(time.perf_counter() - t0)
    res["peak_bytes"] = np.asarray(torch.cuda.max_memory_allocated() - base)
    res["logits"] = torch.stack(steps, 1).cpu().numpy()
    res["greedy"] = torch.cat(greedy, 1).cpu().numpy()
    res["collective_names"] = np.asarray(sorted(coll))
    res["collectives"] = np.asarray([coll[k] for k in sorted(coll)])
    res["collective_bytes"] = np.asarray([sent[k] for k in sorted(sent)], dtype=np.int64)
    counts = kernels.launch_counts()
    res["launch_names"] = np.asarray(sorted(counts))
    res["launches"] = np.asarray([counts[k] for k in sorted(counts)])
    anchor = None
    if not split and MA5_TOL[name] == "anchor":  # after the counts and the peak
        import dataclasses

        from torch.utils._pytree import tree_map

        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
        params32 = tree_map(lambda t: t.float(), params)
        fed = torch.cat(greedy, 1)
        with torch.no_grad():
            _, anchor = transformer.prefill(params32, cfg32, tok, max_seq=max_seq)
            out32 = []
            for i in range(MA5_STEPS):
                l32, anchor = transformer.decode_step(params32, cfg32, fed[:, i:i + 1], anchor, s + i)
                out32.append(l32[:, -1])
        res["anchor_logits"] = torch.stack(out32, 1).cpu().numpy()
        del params32, out32
    if not split:  # the control, after the counts and the anchor
        w = next(x for _, x in _named_leaves(params["stacks"][0]) if x.dim() >= 3)
        fed = torch.cat(greedy, 1)
        with torch.no_grad():
            w.view(torch.int16 if w.element_size() == 2 else torch.int32).view(-1)[0] += 1
            moved, cc = transformer.prefill(params, cfg, tok, max_seq=max_seq)
            gaps = [float((moved.float() - first).norm() / first.norm())]
            for i in range(MA5_STEPS):
                moved, cc = transformer.decode_step(params, cfg, fed[:, i:i + 1], cc, s + i)
                gaps.append(float((moved[:, -1].float() - steps[i]).norm() / steps[i].norm()))
        res["ulp_gap"] = np.asarray(gaps)  # the prefill's, then each decode step's
        del moved, cc
    for prefix, held in (("", caches), ("anchor_", anchor)):
        for j, specs in layout.items() if held is not None else ():
            for k, spec in specs.items():
                leaf = held[j][k].float()
                for r in ((None,) if split else range(mesh.size)):
                    block = leaf if split else lsh.block_of(leaf, spec, mesh, rank=r)
                    flat = block.reshape(-1)
                    tag = f"{prefix}state_{j:02d}_{k}" + ("" if split else f"_r{r}")
                    res[tag] = flat[::-(-flat.numel() // MA_SAMPLE)].cpu().numpy()
    del params, caches, logits, steps, first, anchor
    torch.cuda.empty_cache()
    return res


def ma5_counted(torch, cfg, s: int) -> dict:
    """(ma5)'s first decode step counted as rank 0 of MA_MESH on ``meta``
    tensors: the collectives by kind and their bytes."""
    from repro_torch.analysis.cost import CountingMesh, count
    from repro_torch.launch import sharding as lsh
    from repro_torch.launch.dryrun import _cut
    from repro_torch.models import sharding as msh
    from repro_torch.models import transformer

    mesh = CountingMesh(("data", "model"), MA_MESH)
    max_seq = s + MA5_STEPS
    blocks = lsh.param_shardings(transformer.init_params(cfg, None, "meta"), mesh, False, rank=0)
    caches = transformer.init_caches(cfg, MA5_BATCH, max_seq, device="meta")
    specs = lsh.cache_shardings(caches, mesh, max_seq, MA5_BATCH)
    caches = [_cut(c, sp, mesh) for c, sp in zip(caches, specs)]
    tok = torch.empty((MA5_BATCH, 1), dtype=torch.int64, device="meta")
    rules = lsh.activation_rules(mesh)
    rules["batch"] = None
    with msh.use_rules(mesh, rules):
        cost, _ = count(lambda p, t, c: transformer.decode_step(
            p, cfg, t, c, s, max_seq=max_seq, batch=MA5_BATCH), blocks, tok, caches)
    return {"collectives": cost.collectives, "collective_bytes": cost.collective_bytes}


def _gap(np, a, b) -> float:
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)


def ma_predicted_peak(torch, cfg) -> tuple:
    """(ma4): (ma1)'s prefill counted as rank 0 of ``MA_MESH`` on ``meta``
    tensors: (arguments, temporaries, the collectives by kind)."""
    from repro_torch.analysis.cost import CountingMesh, count
    from repro_torch.launch import sharding as lsh
    from repro_torch.models import sharding as msh
    from repro_torch.models import transformer

    mesh = CountingMesh(("data", "model"), MA_MESH)
    blocks = lsh.param_shardings(transformer.init_params(cfg, None, "meta"), mesh, False, rank=0)
    tok = torch.empty((8, 512), dtype=torch.int64, device="meta")
    rules = lsh.activation_rules(mesh)
    rules["batch"] = None
    with msh.use_rules(mesh, rules):
        cost, _ = count(lambda p, t: transformer.prefill(p, cfg, t), blocks, tok)
    return cost.argument_size_bytes, cost.temp_size_bytes, cost.collectives


def model_axis_phase(torch, card: str) -> dict:
    """(ma1)-(ma4) (the comment above ``MA_MESH``): each case here unsplit,
    then on two processes over gloo on the card; gaps, collectives, peaks,
    kernel launches on each rank.  Returns both ranks' launches of
    (ma1)-(ma3)."""
    phase("model_axis")
    import socket
    import tempfile

    import numpy as np

    from repro_torch import api, kernels

    t_phase = time.perf_counter()
    launches = {k: 0 for k in kernels.launch_counts()}
    ones = {name: ma_case(torch, name, False) for name in MA_CASES}
    spec = dict((label, s) for label, s, _ in ranks_specs(api))[MA3_LABEL]
    ones["ma3"] = ranks_run(torch, spec)
    ones.update({name: ma5_case(torch, name, False) for name in MA5})
    ones["ma6"] = ranks_run(torch, ma6_spec(api))
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="model_axis_"))
    for name in MA5:  # the tokens the ranks are fed
        np.save(tmp / f"{ma5_slug(name)}_tokens.npy", ones[name]["greedy"][:, :MA5_STEPS])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--model-axis-worker", str(r), str(port),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"model_axis: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    print(f"model_axis: two processes over gloo on one card, {time.perf_counter() - t0:.1f} s "
          "from start to exit", flush=True)
    failures = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failures.append(msg)
            print(f"FAILED: {msg}", flush=True)

    res = {name: [dict(np.load(tmp / f"ma{i}_r{r}.npz")) for r in range(2)]
           for i, name in enumerate(MA_CASES)}
    res["ma3"] = [dict(np.load(tmp / f"run_r{r}.npz")) for r in range(2)]
    res["ma6"] = [dict(np.load(tmp / f"ma6_r{r}.npz")) for r in range(2)]
    for name in MA5:
        for tag in ("", "_planted"):
            res[name + tag] = [dict(np.load(tmp / f"{ma5_slug(name)}{tag}_r{r}.npz"))
                               for r in range(2)]
    planted = [dict(np.load(tmp / f"ma{len(MA_CASES)}_r{r}.npz")) for r in range(2)]

    def leaf_gaps(rr, one, prefix):
        return [_gap(np, rr[k], one[k]) for k in sorted(one) if k.startswith(prefix)]

    for name in MA_CASES:
        one, (r0, r1) = ones[name], res[name]
        keys = ["logits"] if "logits" in one else sorted(
            k for k in one if k.startswith(("param_", "update_"))) + ["norms", "loss"]
        for k in keys:
            expect(np.array_equal(r0[k], r1[k]), f"{name}: the ranks differ in {k}")
        greedy = ""
        if name == "ma1 round f32":
            gaps = {f"{name} update": max(leaf_gaps(r0, one, "update_")),
                    f"{name} norms": _gap(np, r0["norms"], one["norms"]),
                    f"{name} loss": _gap(np, r0["loss"], one["loss"]),
                    f"{name} kernel 2": max(float(rr["kernel2_gap"]) for rr in (r0, r1))}
            print(f"{name} ({card}): largest leaf gap of the update {gaps[f'{name} update']:.4g} "
                  f"(median {float(np.median(leaf_gaps(r0, one, 'update_'))):.4g}; bf16's limit "
                  f"{MA_TOL['ma1 round update']}), of the parameters after the step "
                  f"{max(leaf_gaps(r0, one, 'param_')):.4g}", flush=True)
        elif name == "ma1 round":
            gaps = {"ma1 round update": max(leaf_gaps(r0, one, "update_")),
                    "ma1 round norms": _gap(np, r0["norms"], one["norms"]),
                    "ma1 round loss": _gap(np, r0["loss"], one["loss"]),
                    "ma1 round kernel 2": max(float(rr["kernel2_gap"]) for rr in (r0, r1))}
            params_gap = max(leaf_gaps(r0, one, "param_"))
            plant_update = max(leaf_gaps(planted[0], one, "update_"))
            plant_params = max(leaf_gaps(planted[0], one, "param_"))
            split = r0["split_leaf"]

            def on_split(rr, prefix):
                return max(g for g, s in zip(leaf_gaps(rr, one, prefix), split) if s)

            expect(plant_update > MA_TOL["ma1 round update"],
                   f"ma1 round: the planted fault's update gap {plant_update:.3g} is within the "
                   f"limit {MA_TOL['ma1 round update']}")
            print(f"ma1 round ({card}): largest leaf gap of the update {gaps['ma1 round update']:.4g}"
                  f" (median {float(np.median(leaf_gaps(r0, one, 'update_'))):.4g}), of the "
                  f"parameters after the step {params_gap:.4g}; planted fault (the MLP input's "
                  f"gradient unsummed over model): update {plant_update:.4g}, parameters "
                  f"{plant_params:.4g}; on the {int(split.sum())} leaves split over model: "
                  f"update {on_split(r0, 'update_'):.4g}, planted update "
                  f"{on_split(planted[0], 'update_'):.4g}, planted parameters "
                  f"{on_split(planted[0], 'param_'):.4g}; kernel 2 on each rank's blocks "
                  f"({int(r0['kernel2_entries'])} entries, C = {MA_ROUND['cohort']}) against "
                  f"weighted_delta_sum on its deltas: gap "
                  f"{[float(rr['kernel2_gap']) for rr in (r0, r1)]}, max abs err "
                  f"{[float(rr['kernel2_max_abs_err']) for rr in (r0, r1)]}", flush=True)
        else:
            gaps = {name: _gap(np, r0["logits"], one["logits"])}
            agree = float((r0["logits"].argmax(-1) == one["logits"].argmax(-1)).mean())
            greedy = f"; greedy tokens agree {agree:.3f}"
        for k, v in gaps.items():
            expect(v <= MA_TOL[k], f"{k}: gap {v:.3g} against one process (tolerance {MA_TOL[k]})")
        names = [str(k) for k in r0["launch_names"]]
        per_rank = [{k: int(v) for k, v in zip(names, rr["launches"]) if v} for rr in (r0, r1)]
        for got in per_rank:
            expect(got.get("rmsnorm", 0) > 0 and got.get("flash_attention", 0) > 0,
                   f"{name}: kernels 6 and 7 must launch on each rank, got {got}")
            if name.startswith("ma1 round"):
                expect(got.get("fused_cohort_agg_and_error", 0) == 1,
                       f"{name}: kernel 2 once on each rank's blocks, got {got}")
            for k, v in got.items():
                launches[k] += v
        one_l = {str(k): int(v) for k, v in zip(one["launch_names"], one["launches"]) if v}
        coll = {str(k): int(v) for k, v in zip(r0["collective_names"], r0["collectives"]) if v}
        print(f"{name} ({card}): two ranks against one process, gaps "
              f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }"
              f"{greedy}; collectives a rank {coll}; peak "
              f"bytes one process {int(one['peak_bytes'])} rank 0 {int(r0['peak_bytes'])} rank 1 "
              f"{int(r1['peak_bytes'])} (held: {int(one['held_bytes'])} / "
              f"{int(r0['held_bytes'])}); seconds one process {float(one['seconds']):.3f} rank 0 "
              f"{float(r0['seconds']):.3f} rank 1 {float(r1['seconds']):.3f} (both ranks share the "
              f"card: no speed-up); launches one process {one_l} rank 0 {per_rank[0]} rank 1 "
              f"{per_rank[1]}", flush=True)
    one, (r0, r1) = ones["ma3"], res["ma3"]
    for k in ("loss", "cohort", "dropped") + tuple(k for k in one if k.startswith("param_")):
        expect(np.array_equal(r0[k], one[k]) and np.array_equal(r1[k], one[k]),
               f"(ma3): {k} at mesh (1, 2) differs from S = 1")
    for rr in (r0, r1):
        for k, v in zip(rr["launch_names"], rr["launches"]):
            launches[str(k)] += int(v)
    coll = {str(k): int(v) for k, v in zip(r0["collective_names"], r0["collectives"]) if v}
    print(f"(ma3) api.run {MA3_LABEL} on mesh (1, 2) ({card}): both ranks bitwise the S = 1 "
          f"run (loss {one['loss'].tolist()}); collectives a rank {coll or 'none'}; wall s S=1 "
          f"{float(one['wall_s']):.3f} rank 0 {float(r0['wall_s']):.3f} rank 1 "
          f"{float(r1['wall_s']):.3f}; peak bytes S=1 {int(one['peak_bytes'])} rank 0 "
          f"{int(r0['peak_bytes'])} rank 1 {int(r1['peak_bytes'])}", flush=True)
    for name in MA5:
        ma5_report(torch, np, name, ones[name], res[name], res[name + "_planted"], launches, card,
                   expect)
    ma6_report(np, api, ones["ma6"], res["ma6"], launches, card, expect)
    # (ma4): the count of one rank against the card, then the CLI records.
    workspace = cublas_workspace(torch)
    args_b, temp_b, counted = ma_predicted_peak(torch, ma_config("ma1 prefill"))
    predicted = args_b + temp_b + workspace
    for r, rr in enumerate(res["ma1 prefill"]):
        peak = int(rr["peak_bytes"])
        band = max(PEAK_BAND[0] * peak, PEAK_BAND[1])
        expect(abs(predicted - peak) <= band,
               f"(ma4): rank {r}'s prefill peak {peak} B, predicted {predicted} B")
        print(f"(ma4) (ma1) prefill, rank {r} of (1, 2) ({card}): peak predicted "
              f"{predicted / 1e9:.3f} GB (arguments {args_b / 1e9:.3f} + temporaries "
              f"{temp_b / 1e9:.3f} + one cuBLAS workspace {workspace / 1e6:.1f} MB) against the "
              f"card's {peak / 1e9:.3f} GB ({predicted / peak - 1:+.2%})", flush=True)
    issued = {str(k).replace("_", "-"): int(v) for k, v in
              zip(res["ma1 prefill"][0]["collective_names"], res["ma1 prefill"][0]["collectives"])
              if v}
    expect(counted == issued, f"(ma4): counted collectives {counted}, issued {issued}")
    out_dir = ROOT / "results" / "torch" / "smoke" / "dryrun_mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.json"):
        old.unlink()
    for job, tag in MA_CLI:
        rc, stdout, err, cli_s = cpu_job(job)
        expect(rc == 0, f"{job}: {err[-2000:]}")
        if rc != 0:
            continue
        record = json.loads(stdout.strip().splitlines()[-1])
        expect(record["status"] == "ok" and record["collectives"],
               f"{job}: {record.get('status')}, collectives {record.get('collectives')}")
        if record["arch"] == "zamba2-1.2b":  # 64 heads over 16: the state rule's split
            expect(record["collective_bytes"] <= MA5_BYTES["ma5 zamba2"],
                   f"{job}: {record['collective_bytes']:.6g} collective bytes counted, limit "
                   f"{MA5_BYTES['ma5 zamba2']:.3g}")
        print(f"(ma4) {job}: {cli_s:.1f} s on the card's CPU; n_chips {record['n_chips']} mesh "
              f"{record['mesh']}; rank 0's parameter bytes {record['param_bytes']} "
              f"({record['param_bytes'] / 1e9:.4f} GB); memory {record['memory']}; flops "
              f"{record['flops']:.4g}; bytes {record['bytes_accessed']:.4g}; collective bytes "
              f"{record['collective_bytes']:.4g}; collectives {record['collectives']}", flush=True)
        (out_dir / f"{record['arch']}__{record['shape']}__{tag}.json").write_text(
            json.dumps(record, indent=1))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report", "--dir",
                           str(out_dir)], capture_output=True, text=True, timeout=120, env=env,
                          cwd=str(ROOT))
    expect(proc.returncode == 0 and "| 16x16 | ok |" in proc.stdout,
           f"analysis.report over the mesh records: {proc.stderr[-2000:]}")
    print(proc.stdout, flush=True)
    check(not failures, "model_axis: " + "; ".join(failures))
    print(f"model_axis phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


MA_CLI = (("dryrun llama3-405b train_4k 16x16", "sp"), ("dryrun smollm-360m train_4k 2x16x16", "mp"),
          ("dryrun zamba2-1.2b decode_32k 16x16", "sp"),
          ("dryrun xlstm-125m long_500k 2x16x16", "mp"))


def ma5_held(np, name: str, one: dict, ranks: list) -> tuple:
    """(what failed, what was held): the split run ``ranks`` against one
    process's ``one`` by ``MA5_TOL[name]`` (the comment above ``MA5``)."""
    tol, failed, held = MA5_TOL[name], [], []
    steps = range(MA5_STEPS)
    if tol == "anchor":
        pairs = {"logits": [(_gap(np, one["logits"][:, i], one["anchor_logits"][:, i]),
                             _gap(np, ranks[0]["logits"][:, i], one["anchor_logits"][:, i]))
                            for i in steps],
                 "state": [(_gap(np, one[f"{k}_r{r}"], one[f"anchor_{k}_r{r}"]),
                            _gap(np, rr[k], one[f"anchor_{k}_r{r}"]))
                           for r, rr in enumerate(ranks) for k in rr if k.startswith("state_")]}
        for what, got in pairs.items():
            one_max, split_max = max(p[0] for p in got), max(p[1] for p in got)
            held.append(f"{what}: one process's bf16 run {one_max:.4g} from its f32 run, the "
                        f"split's {split_max:.4g} (ratio {split_max / one_max:.3f}, limit "
                        f"{MA5_ANCHOR})")
            if not split_max <= MA5_ANCHOR * one_max:
                failed.append(held[-1])
        return failed, "; ".join(held)
    step_gap = max(_gap(np, ranks[0]["logits"][:, i], one["logits"][:, i]) for i in steps)
    state_gap = max(_gap(np, rr[k], one[f"{k}_r{r}"]) for r, rr in enumerate(ranks)
                    for k in rr if k.startswith("state_"))
    for what, got in (("logits", step_gap), ("state", state_gap)):
        held.append(f"{what}: largest gap {got:.4g}, limit {tol[what]}")
        if not got <= tol[what]:
            failed.append(held[-1])
    return failed, "; ".join(held)


def ma5_report(torch, np, name: str, one: dict, ranks: list, planted: list, launches: dict,
               card: str, expect) -> None:
    """(ma5) ``name``: the ranks against one process, and the planted
    fault's run rejected by the same check (the comment above ``MA5``)."""
    from repro_torch.launch.sharding import spec_axes

    arch, s, dtype = MA5[name]
    cfg = ma5_config(name)
    r0, r1 = ranks
    for k in ("logits", "greedy"):  # each rank holds its own state blocks
        expect(np.array_equal(r0[k], r1[k]), f"{name}: the ranks differ in {k}")
    expect(bool(np.isfinite(r0["logits"]).all()), f"{name}: non-finite logits")
    failed, held = ma5_held(np, name, one, ranks)
    for what in failed:
        expect(False, f"{name}: {what}")
    caught, planted_held = ma5_held(np, name, one, planted)
    expect(bool(caught), f"{name}: the planted fault passed the check ({planted_held})")
    step_gaps = [_gap(np, r0["logits"][:, i], one["logits"][:, i]) for i in range(MA5_STEPS)]
    agree = float((r0["greedy"] == one["greedy"]).mean())
    state = {f"{k}_r{r}": _gap(np, rr[k], one[f"{k}_r{r}"]) for r, rr in enumerate(ranks)
             for k in rr if k.startswith("state_")}
    _, layout = ma5_layout(cfg, s)
    split = sum(any(spec_axes(e) for e in spec) for specs in layout.values()
                for spec in specs.values())
    worst = max(state, key=state.get)
    expect(split > 0, f"{name}: no recurrent cache leaf is split over model")
    issued = {str(k).replace("_", "-"): int(v) for k, v in
              zip(r0["collective_names"], r0["collectives"]) if v}
    sent = [int(rr["collective_bytes"].sum()) for rr in ranks]
    counted = ma5_counted(torch, cfg, s)
    expect(counted["collectives"] == issued,
           f"{name}: a decode step's collectives counted {counted['collectives']}, issued {issued}")
    for r, got in enumerate(sent):
        expect(got == counted["collective_bytes"] and got <= MA5_BYTES[name],
               f"{name}: rank {r}'s decode step moved {got} B, counted "
               f"{counted['collective_bytes']:.10g} (limit {MA5_BYTES[name]:.3g})")
    as_counted = counted["collectives"] == issued and sent == [counted["collective_bytes"]] * 2
    one_l = {str(k): int(v) for k, v in zip(one["launch_names"], one["launches"]) if v}
    for r, rr in enumerate(ranks):
        got = {str(k): int(v) for k, v in zip(rr["launch_names"], rr["launches"]) if v}
        expect(got == one_l, f"{name}: rank {r} launched {got}, one process {one_l}")
        for k, v in got.items():
            launches[k] += v
    print(f"{name} {arch} whole, {dtype}, batch {MA5_BATCH}, prompt {s}, {MA5_STEPS} decode steps "
          f"at mesh {MA_MESH} ({card}): held ({held}); the planted fault's run "
          f"({planted_held}) rejected: {bool(caught)}; largest logits gap of a step "
          f"{max(step_gaps):.4g} (each step {[float(f'{g:.3g}') for g in step_gaps]}; one process "
          f"with one weight moved by one ulp moves its prefill's logits by "
          f"{float(one['ulp_gap'][0]):.4g}, a decode step's by up to "
          f"{float(one['ulp_gap'][1:].max()):.4g}); the ranks' own greedy tokens agree with one process's in "
          f"{agree:.4f}; state blocks ({len(state)} leaves over 2 ranks, {split} of "
          f"{sum(len(v) for v in layout.values())} leaves split over model, at most {MA_SAMPLE} "
          f"entries a leaf) largest gap {state[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(state.values()))):.4g}; collectives a decode step a rank "
          f"{issued}, bytes the ranks' calls returned {sent} (counted "
          f"{counted['collective_bytes']:.10g}: {as_counted}); peak bytes one process "
          f"{int(one['peak_bytes'])} rank 0 {int(r0['peak_bytes'])} rank 1 {int(r1['peak_bytes'])}; "
          f"seconds one process prefill {float(one['prefill_s']):.3f} decode "
          f"{float(one['decode_s']):.3f}, rank 0 prefill {float(r0['prefill_s']):.3f} decode "
          f"{float(r0['decode_s']):.3f} (both ranks share the card: no speed-up); launches a rank "
          f"{one_l}", flush=True)


def ma6_report(np, api, one: dict, ranks: list, launches: dict, card: str, expect) -> None:
    """(ma6): the MoE cohort_sequential round over rows split 2 / 1 against
    S = 1 (the comment above ``MA6_KW``)."""
    from repro_torch.api.runner import build as api_build

    spec = ma6_spec(api)
    r0, r1 = ranks
    for k in r0:
        expect(np.array_equal(r0[k], r1[k]) or k in ("wall_s", "peak_bytes", "n_bytes", "n_shapes"),
               f"(ma6): the ranks differ in {k}")
    for k in ("cohort", "dropped"):
        expect(np.array_equal(r0[k], one[k]), f"(ma6): {k} {r0[k]} at S=2, {one[k]} at S=1")
    _, f_tol, p_tol = F32_TOL
    keys = sorted(k for k in one if k.startswith("param_") and k != "param_names")
    gaps = [_rel(r0[k], one[k]) for k in keys]
    worst = int(np.argmax(gaps))
    loss = _rel(r0["loss"], one["loss"])
    expect(loss <= f_tol, f"(ma6): loss differs by {loss:.3g} of its scale (tolerance {f_tol})")
    expect(gaps[worst] <= p_tol, f"(ma6): parameters differ by {gaps[worst]:.3g} (tolerance {p_tol})")
    cfg = api_build(spec).arch_config
    want = {k: 0 for k in (str(x) for x in r0["launch_names"])}
    want.update(ranks_launches(cfg, spec, RANKS))
    for r, rr in enumerate(ranks):
        got = {str(k): int(v) for k, v in zip(rr["launch_names"], rr["launches"])}
        expect(got == want, f"(ma6): rank {r} launched {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v
    coll = {str(k): int(v) for k, v in zip(r0["collective_names"], r0["collectives"]) if v}
    print(f"(ma6) qwen3-moe reduced f32 cohort_sequential, local batch 3 (rows 2 / 1), capacity "
          f"factor {MA6_KW['capacity_factor']}, {spec.federation.rounds} rounds on mesh (2, 1) "
          f"({card}): against S = 1 loss {loss:.3g}, parameters {gaps[worst]:.3g} of the "
          f"largest entry in {one['param_names'][worst]}; both ranks bitwise equal; cohorts "
          f"{r0['cohort'].tolist()}; collectives a rank {coll}; wall s S=1 "
          f"{float(one['wall_s']):.3f} rank 0 {float(r0['wall_s']):.3f}; peak bytes S=1 "
          f"{int(one['peak_bytes'])} rank 0 {int(r0['peak_bytes'])}.  The full-width round needs "
          f"several cards ((z)'s one layer peaks at 58 GB in one process)", flush=True)


# -- 4. path ------------------------------------------------------------------


def path_specs(api):
    """(label, spec, expected kernel launches of the 5-round run)."""
    logreg = api.ExperimentSpec(  # the paper's Section 6.1 spec (examples/quickstart.py)
        task=api.TaskSpec(
            name="logreg", dataset="synthetic_classification",
            dataset_kwargs=dict(n_clients=100, total=20000, power=2.0, seed=0),
        ),
        sampler=api.SamplerSpec(name="kvib", kwargs={"horizon": ROUNDS}),
        federation=api.FederationSpec(
            rounds=ROUNDS, budget=10, local_steps=2, batch_size=64, local_lr=0.02
        ),
        execution=api.ExecutionSpec(seed=0),
    )
    lm = api.ExperimentSpec(  # examples/fed_lm.py's tiny LM at full default width
        task=api.TaskSpec(
            name="tiny_lm", kwargs=dict(vocab=256),
            dataset="synthetic_tokens",
            dataset_kwargs=dict(n_clients=50, seq_len=32, vocab=256, total_seqs=3000, power=2.2, seed=0),
        ),
        sampler=api.SamplerSpec(name="kvib", kwargs={"horizon": ROUNDS}),
        federation=api.FederationSpec(
            rounds=ROUNDS, budget=5, local_steps=1, batch_size=8, local_lr=0.3
        ),
        execution=api.ExecutionSpec(seed=0),
    )
    lm_deploy = with_sections(api, lm, execution={"oracle_metrics": False})
    multi, cohort, dequant = (
        {"fused_multi_weighted_agg": ROUNDS}, {"fused_cohort_agg_and_error": ROUNDS},
        {"fused_dequant_cohort_agg": ROUNDS},
    )
    solve = {"waterfill_level_stats": LADDER_PASSES * ROUNDS}
    return [
        ("logreg oracle", logreg, multi),
        ("tiny_lm oracle", lm, multi),
        ("tiny_lm deployable", lm_deploy, cohort),
        ("(d) tiny_lm deployable int8+EF",
         with_sections(api, lm_deploy, compression={"delta_dtype": "int8"}), dequant),
        ("(e) tiny_lm oracle fp8+EF", with_sections(api, lm, compression={"delta_dtype": "fp8"}),
         dequant),
        ("(f) logreg oracle int8 no EF",
         with_sections(api, logreg, compression={"delta_dtype": "int8", "error_feedback": False}),
         dequant),
        ("(g) logreg oracle sampler_axis", sharded_logreg(api, logreg), {**multi, **solve}),
        ("(h) tiny_lm deployable sampler_axis markov+deadline+async", faulted_lm(api, lm_deploy),
         {**cohort, **solve}),
        ("(i) tiny_lm oracle int8+EF bernoulli+async",
         with_sections(api, lm, compression={"delta_dtype": "int8"},
                       fault={"availability": "bernoulli", "availability_kwargs": {"q": 0.7},
                              "async_buffer": 4}),
         dequant),
    ]


def sharded_logreg(api, logreg):
    return with_sections(api, logreg, execution={"sampler_axis": "data"})


def faulted_lm(api, lm_deploy):
    """(h): the sharded solve, Markov availability, an exponential deadline
    that drops about a third of the contacted clients, buffered async."""
    return with_sections(
        api, lm_deploy, execution={"sampler_axis": "data"},
        fault={"availability": "markov", "availability_kwargs": {"p_on": 0.6, "p_off": 0.2},
               "deadline": 1.2, "latency": "exponential", "async_buffer": 4},
    )


def with_sections(api, spec, **sections):
    """``spec`` with the given sections' fields replaced."""
    d = spec.to_dict()
    return api.ExperimentSpec.from_dict({**d, **{k: {**d[k], **v} for k, v in sections.items()}})


def path_phase(torch):
    phase("path")
    import numpy as np

    from repro_torch import api, kernels

    launches = {k: 0 for k in kernels.launch_counts()}
    hists = {}
    for label, spec, expected in path_specs(api):
        t0 = time.perf_counter()
        built = api.build(spec)
        build_s = time.perf_counter() - t0
        check(built.device.type == "cuda", f"{label}: default device is {built.device}")
        kernels.reset_launch_counts()
        hist = api.run(spec, built=built)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        check(len(hist.train_loss) == ROUNDS, f"{label}: {len(hist.train_loss)} rounds")
        check(all(math.isfinite(x) for x in hist.train_loss), f"{label}: loss {hist.train_loss}")
        check(all(math.isfinite(x) for x in hist.estimator_sq_error), f"{label}: sq_error")
        for leaf in _leaves(hist.final_params):
            check(bool(np.isfinite(leaf).all()), f"{label}: non-finite parameters")
        want = {k: expected.get(k, 0) for k in counts}
        check(counts == want, f"{label}: kernel launches {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        hists[label] = hist
        d_dim = sum(leaf.size for leaf in _leaves(hist.final_params))
        extra = f" deadline_dropped={hist.deadline_dropped}" if hist.deadline_dropped else ""
        print(
            f"{label}: D={d_dim} N={built.dataset.n_clients} rounds={ROUNDS} "
            f"build_s={build_s:.3f} run_wall_s={hist.wall_time_s:.3f} "
            f"loss {hist.train_loss[0]:.4f} -> {hist.train_loss[-1]:.4f} "
            f"cohort={hist.cohort_size}{extra} launches={ {k: v for k, v in counts.items() if v} }",
            flush=True,
        )
    # (g) splits the solve and must change nothing: bitwise the plain run.
    g, plain = hists["(g) logreg oracle sampler_axis"], hists["logreg oracle"]
    for field in ("train_loss", "cohort_size", "estimator_sq_error"):
        check(getattr(g, field) == getattr(plain, field), f"(g): {field} differs from the unsharded run")
    check(g.regret.costs == plain.regret.costs, "(g): regret costs differ")
    for a, b in zip(_leaves(g.final_params), _leaves(plain.final_params)):
        check(np.array_equal(a, b), "(g): final parameters differ from the unsharded run")
    print("(g) == logreg oracle without sampler_axis: History and final parameters bitwise equal")
    h = hists["(h) tiny_lm deployable sampler_axis markov+deadline+async"]
    check(sum(h.deadline_dropped) > 0, f"(h): no client missed the deadline {h.deadline_dropped}")
    launches["fused_weighted_agg"] += ops_call(torch, api, kernels)
    launches["waterfill_level_stats"] += sampler_scale_phase(torch, kernels)
    serve_launches, engines = serve_path_phase(torch, kernels)
    for k, v in serve_launches.items():
        launches[k] += v
    return launches, engines


# -- 4b. samplers ---------------------------------------------------------------

# The samplers phase runs each registry sampler with its defaults (a
# horizon of 5 would set K-Vib's and vrb's mixing theta to 1 at N = 100,
# i.e. uniform), clustered K-Vib with the logreg spec's N = 100 clients in
# 10 clusters.
SAMPLER_KWARGS = {"clustered_kvib": {"cluster_ids": tuple(i % 10 for i in range(100))}}


def replay_tables(torch, np, built, seed: int) -> dict:
    """A run's draws as numpy tables from ``seed``: initial parameters, the
    ISP uniforms and cohort priorities, the RSP draws' uniforms and clients,
    and the batch indices."""
    from repro_torch.fed.tasks import params_to_numpy

    rng = np.random.default_rng(seed)
    cfg, n = built.fed_config, built.dataset.n_clients
    t, k, r, b = cfg.rounds, cfg.budget, cfg.local_steps, cfg.batch_size
    sizes = built.dataset.sizes.numpy()
    init = built.task.init(torch.Generator().manual_seed(seed), "cpu")
    return dict(
        init_params=params_to_numpy(init),
        uniforms=rng.uniform(size=(t, n)).astype(np.float32),
        priorities=rng.uniform(size=(t, n)).astype(np.float32),
        batch_idx=(rng.uniform(size=(t, n, r, b)) * sizes[:, None, None]).astype(np.int64),
        rsp_uniforms=rng.uniform(size=(t, k)).astype(np.float32),
        rsp_indices=np.stack([rng.permutation(n)[:k] for _ in range(t)]),
    )


def samplers_phase(torch, card: str) -> dict:
    """Each of the nine registry samplers on the paper's logreg oracle spec
    (N=100, K=10, D=610, 5 rounds), and vrb on the deployable tiny LM, run
    by ``api.run`` on the card and on the CPU from one ``ReplaySource``:
    the draws' masks and counts equal on the two devices, the final
    parameters within 1e-5 of each leaf's largest magnitude, and loss,
    squared error and regret costs within 1e-5 relative; the card's run
    launches kernel 1 (oracle) or kernel 2 (deployable) once a round and
    nothing else.  Prints seconds a round on the card.  Returns the
    launches of the card's runs."""
    phase("samplers")
    import numpy as np

    from repro_torch import api, kernels
    from repro_torch.core import samplers as smp
    from repro_torch.rng import ReplaySource

    specs = {label: spec for label, spec, _ in path_specs(api)}
    runs = [
        (f"{name} logreg oracle",
         with_sections(api, specs["logreg oracle"],
                       sampler={"name": name, "kwargs": SAMPLER_KWARGS.get(name, {})}),
         "fused_multi_weighted_agg")
        for name in smp.sampler_names()
    ]
    runs.append(("vrb tiny_lm deployable",
                 with_sections(api, specs["tiny_lm deployable"],
                               sampler={"name": "vrb", "kwargs": {}}),
                 "fused_cohort_agg_and_error"))
    real_sample_from = smp.Sampler.sample_from
    launches = {k: 0 for k in kernels.launch_counts()}
    per_round = {}
    for label, spec, kernel in runs:
        tables = replay_tables(torch, np, api.build(spec, "cpu"), seed=0)
        hists, draws = {}, {}
        for dev in ("cuda", "cpu"):
            log = draws[dev] = []

            def recording(self, probs, draw_input, log=log):
                res = real_sample_from(self, probs, draw_input)
                log.append((res.mask.clone(), res.counts.clone()))
                return res

            smp.Sampler.sample_from = recording
            try:
                kernels.reset_launch_counts()
                hists[dev] = api.run(spec, dev, random_source=ReplaySource(**tables, device=dev))
                counts = kernels.launch_counts()
            finally:
                smp.Sampler.sample_from = real_sample_from
            if dev == "cuda":
                want = {k: ROUNDS * (k == kernel) for k in counts}
                check(counts == want, f"samplers {label}: launches {counts}, expected {want}")
                for k, v in counts.items():
                    launches[k] += v
        gpu, cpu = hists["cuda"], hists["cpu"]
        check(len(draws["cuda"]) == len(draws["cpu"]) == ROUNDS, f"samplers {label}: draws")
        for (m_g, c_g), (m_c, c_c) in zip(draws["cuda"], draws["cpu"]):
            check(torch.equal(m_g.cpu(), m_c) and torch.equal(c_g.cpu(), c_c),
                  f"samplers {label}: GPU and CPU draws differ")
        check(gpu.cohort_size == cpu.cohort_size, f"samplers {label}: cohort sizes differ")
        fields = ["train_loss"]
        if spec.execution.oracle_metrics:
            fields.append("estimator_sq_error")
            np.testing.assert_allclose(gpu.regret.costs, cpu.regret.costs, rtol=1e-5, atol=0)
            np.testing.assert_allclose(gpu.regret.opt_costs, cpu.regret.opt_costs, rtol=1e-5, atol=0)
        for field in fields:
            np.testing.assert_allclose(getattr(gpu, field), getattr(cpu, field), rtol=1e-5, atol=0)
        rel = 0.0
        for a, b in zip(_leaves(gpu.final_params), _leaves(cpu.final_params)):
            scale = float(np.abs(b).max())
            check(bool(np.isfinite(a).all()), f"samplers {label}: non-finite parameters")
            diff = float(np.abs(a - b).max())
            check(diff <= 1e-5 * scale, f"samplers {label}: parameters off by {diff} of {scale}")
            rel = max(rel, diff / max(scale, 1e-30))
        per_round[label] = gpu.wall_time_s / ROUNDS
        print(f"samplers {label}: GPU == CPU draws (masks, counts) in all {ROUNDS} rounds; "
              f"params max diff {rel:.3g} of the leaf's scale; cohort {gpu.cohort_size}; "
              f"regret costs {['%.6g' % c for c in gpu.regret.costs]}; "
              f"{per_round[label]:.5f} s/round on the card", flush=True)
    print(f"samplers: s/round on the card ({card}): "
          + json.dumps({k: round(v, 5) for k, v in per_round.items()}), flush=True)
    # The RSP draws (the default source's streams) add no host sync to the
    # round: as many as K-Vib's round makes on the same spec.
    syncs = {label: count_round_syncs(torch, api, spec) for label, spec, _ in runs
             if label in ("kvib logreg oracle", "vrb logreg oracle", "uniform_rsp logreg oracle")}
    print("samplers: host syncs in 2 rounds of the round body: "
          + json.dumps({k: len(v) for k, v in syncs.items()}), flush=True)
    for label, found in syncs.items():
        check(len(found) <= len(syncs["kvib logreg oracle"]),
              f"samplers {label}: host syncs {sorted(set(found))[:4]}")
    return launches


# -- 4c. examples -----------------------------------------------------------------

# The examples phase runs the paper's four examples (``repro_torch.examples``)
# at their full widths, with rounds cut: every spec is an oracle run, so
# kernel 1 launches once a round and nothing else does.
EXAMPLE_RUNS = [
    ("quickstart", [], "quickstart.json"),
    ("synthetic_regret", ["--rounds", "60", "--seeds", "1"], "synthetic.json"),
    ("budget_sweep", ["--rounds", "30"], "budget.json"),
    ("femnist_style", ["--rounds", "15"], "femnist.json"),
]


def example_walls(name: str, res: dict) -> dict:
    """Each spec's wall seconds from an example's results."""
    if name == "quickstart":
        return {s: v["wall_time_s"] for s, v in res["summary"].items()}
    if name == "synthetic_regret":
        return {s: runs[0]["wall_s"] for s, runs in res["runs"].items()}
    if name == "budget_sweep":
        return {f"{s} K={k}": w for s, by_k in res["wall_s"].items() for k, w in by_k.items()}
    return {f"{lv} {s}": r["wall_s"] for lv, v in res["levels"].items()
            for s, r in v["samplers"].items()}


def examples_phase(torch, card: str) -> dict:
    """Each port example on the card (default device), its JSON under
    ``results/torch/smoke/``, then ``bench.tables`` on it: every
    fig2 / fig3b / fig4 row present, its numbers finite.  One 2-round run
    of each model shape first warms the card up (not timed); prints each
    spec's wall seconds.  Returns the launches."""
    phase("examples")
    import importlib
    import re

    from repro_torch import api, kernels
    from repro_torch.bench import tables

    mods = {name: importlib.import_module(f"repro_torch.examples.{name}")
            for name, _, _ in EXAMPLE_RUNS}
    out = ROOT / "results" / "torch" / "smoke"
    qs, fem = mods["quickstart"], mods["femnist_style"]
    for spec in (qs.spec_for(qs.parse_args(["--rounds", "2"]), "kvib"),
                 fem.spec_for(fem.parse_args(["--rounds", "2"]), "v1", "kvib")):
        api.run(spec)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rounds, walls = 0, {}
    for name, argv, fname in EXAMPLE_RUNS:
        t0 = time.perf_counter()
        res = mods[name].main(argv + ["--out", str(out / fname)])
        cfg = res["config"]
        check(cfg["device"] is None, f"examples {name}: ran on {cfg['device']}, not the default")
        walls[name] = example_walls(name, res)
        rounds += cfg["rounds"] * len(walls[name])
        print(f"examples {name}: {len(walls[name])} specs x {cfg['rounds']} rounds in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    counts = kernels.launch_counts()
    want = {k: rounds * (k == "fused_multi_weighted_agg") for k in counts}
    check(counts == want, f"examples: kernel launches {counts}, expected {want}")
    rows = {name: derived for name, _, derived in tables.main(["--results-dir", str(out)])
            if not name.startswith("fig5")}  # fed_lm runs in the zoo phase
    syn, bud, fem_s = (mods[n].parse_args([]) for n in ("synthetic_regret", "budget_sweep",
                                                         "femnist_style"))
    expected = ([f"fig2_regretT_{s}" for s in mods["synthetic_regret"].SAMPLERS]
                + [f"fig3b_{s}" for s in bud.samplers]
                + [f"fig4_{lv}_{s}" for lv in mods["femnist_style"].LEVELS for s in fem_s.samplers])
    check(sorted(rows) == sorted(expected), f"examples: table rows {sorted(rows)}")
    for name, derived in rows.items():
        nums = re.findall(r"[-+]?(?:\d+\.\d*|\d+|nan|inf)", derived.replace("K=", "K "))
        check(nums and all(math.isfinite(float(x)) for x in nums),
              f"examples: row {name} is not finite: {derived}")
    print(f"examples: wall seconds a spec on the card ({card}), warm-up excluded: "
          + json.dumps({n: {k: round(v, 4) for k, v in w.items()} for n, w in walls.items()}),
          flush=True)
    return counts


# -- 4d. checkpoint ---------------------------------------------------------------


def checkpoint_phase(torch) -> dict:
    """Preempt and resume on the card: the deployable tiny LM with K-Vib
    (kernel 2), the logreg oracle with vrb (kernel 1) and (i) (int8 + error
    feedback + Bernoulli availability + the async ring, kernel 4), each
    with ``ckpt_every=2``, stopped after one segment (``max_segments=1``)
    and resumed by ``api.run`` through a fresh ``CheckpointManager``:
    History and final parameters bitwise the uninterrupted card run.  Then
    ``exact_oracle_equiv`` at C = N against the oracle logreg run: equal
    draws, and the largest parameter gap.  Returns the launches."""
    phase("checkpoint")
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import api, kernels
    from repro_torch.checkpoint import CheckpointManager, config_fingerprint
    from repro_torch.fed.server import build_segment_runner
    from repro_torch.fed.state import run_segmented

    specs = {label: spec for label, spec, _ in path_specs(api)}
    every = {"execution": {"ckpt_every": 2}}
    cases = [
        ("tiny_lm deployable kvib", with_sections(api, specs["tiny_lm deployable"], **every)),
        ("logreg oracle vrb", with_sections(api, specs["logreg oracle"], **every,
                                            sampler={"name": "vrb", "kwargs": {}})),
        ("(i) tiny_lm oracle int8+EF bernoulli+async",
         with_sections(api, specs["(i) tiny_lm oracle int8+EF bernoulli+async"], **every)),
    ]
    kernels.reset_launch_counts()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for k, (label, spec) in enumerate(cases):
            full = api.run(spec)
            built = api.build(spec)
            cfg, fp, path = built.fed_config, config_fingerprint(spec), f"{root}/{k}"
            segment, st0 = build_segment_runner(built.task, built.dataset, built.sampler, cfg)
            pre = run_segmented(st0, cfg.rounds, segment, ckpt_every=cfg.ckpt_every,
                                manager=CheckpointManager(path, fingerprint=fp), max_segments=1)
            check(pre.round == 2, f"checkpoint {label}: preempted at round {pre.round}")
            t0 = time.perf_counter()
            resumed = api.run(spec, ckpt_manager=CheckpointManager(path, fingerprint=fp))
            resume_s = time.perf_counter() - t0
            for field in ("train_loss", "cohort_size", "cohort_dropped", "deadline_dropped",
                          "estimator_sq_error"):
                check(getattr(resumed, field) == getattr(full, field),
                      f"checkpoint {label}: {field} differs from the uninterrupted run")
            if cfg.oracle_metrics:
                check(resumed.regret.costs == full.regret.costs, f"checkpoint {label}: regret")
            for a, b in zip(_leaves(resumed.final_params), _leaves(full.final_params)):
                check(np.array_equal(a, b), f"checkpoint {label}: final parameters differ")
            size = sum(f.stat().st_size for f in Path(path).iterdir())
            print(f"checkpoint {label}: preempted after round 2, resumed through a fresh "
                  f"manager: History and final parameters bitwise the uninterrupted card run "
                  f"(resume {resume_s:.3f} s, checkpoint directory {size} bytes)", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    oracle = specs["logreg oracle"]
    exact = with_sections(api, oracle, execution={"oracle_metrics": False,
                                                  "exact_oracle_equiv": True},
                          federation={"cohort": 100})
    o, e = api.run(oracle), api.run(exact)
    check(o.cohort_size == e.cohort_size, "exact_oracle_equiv: draws differ from the oracle run")
    gap, rel, bitwise = 0.0, 0.0, True
    for a, b in zip(_leaves(e.final_params), _leaves(o.final_params)):
        diff = float(np.abs(a - b).max())
        gap, bitwise = max(gap, diff), bitwise and np.array_equal(a, b)
        rel = max(rel, diff / max(float(np.abs(b).max()), 1e-30))
    check(rel <= 1e-5, f"exact_oracle_equiv: parameters off the oracle run by {rel} of a leaf")
    print(f"exact_oracle_equiv (logreg, C = N = 100) against the oracle run on the card: "
          f"cohorts equal, bitwise={bitwise}, largest parameter gap {gap:.3g} "
          f"({rel:.3g} of the leaf's scale)", flush=True)
    counts = kernels.launch_counts()
    want = {k: 0 for k in counts}
    want.update(fused_cohort_agg_and_error=2 * ROUNDS, fused_dequant_cohort_agg=2 * ROUNDS,
                fused_multi_weighted_agg=4 * ROUNDS)
    check(counts == want, f"checkpoint: kernel launches {counts}, expected {want}")
    return counts


# -- 4e. zoo --------------------------------------------------------------------

# The zoo round's runs: bf16 at the configs'
# widths, synthetic_tokens at the arch's vocab, seq 64, local batch 2, R = 2
# local steps (the reference launcher's defaults), K-Vib.
ZOO_SEQ, ZOO_BATCH, ZOO_STEPS = 64, 2, 2
GEMMA_PATTERN = dict(  # gemma2-27b at full width, one (attn_local, attn) pattern deep
    n_layers=2, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864, vocab=256000,
    head_dim=128, sliding_window=4096, param_dtype="bfloat16")
HYBRID_4 = dict(n_layers=4, block_pattern=["mamba2", "mamba2", "mamba2", "shared_attn"])
ZOO_RUNS = {  # label: (arch, reduced() kwargs or None for the full config, rounds, N, K, C)
    "(n) smollm-360m": ("smollm-360m", None, 3, 32, 6, 8),
    "(o) zamba2-1.2b": ("zamba2-1.2b", None, 2, 32, 6, 8),
    "(p) gemma2-27b one pattern": ("gemma2-27b", GEMMA_PATTERN, 2, 32, 3, 4),
}
ZOO_ROUND_S: dict = {}  # label -> one round's wall seconds alone (zoo profile)
# The GPU-against-CPU round: smollm-360m's widths, two layers, f32.
AGREE_KW = dict(n_layers=2, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560, vocab=49152)


def zoo_spec(api, arch: str, *, rounds: int, clients: int, budget: int, cohort: int,
             kwargs: dict | None = None, seq: int = ZOO_SEQ, **sections):
    """A ``kind="zoo"`` spec: the full config (``kwargs`` None) or
    ``ArchConfig.reduced(**kwargs)``."""
    d = {
        "task": {"kind": "zoo", "name": arch, "reduced": kwargs is not None,
                 "kwargs": kwargs or {}, "dataset": "synthetic_tokens",
                 "dataset_kwargs": {"n_clients": clients, "seq_len": seq}},
        "sampler": {"name": "kvib", "kwargs": {"horizon": rounds}},
        "federation": {"rounds": rounds, "budget": budget, "cohort": cohort,
                       "local_steps": ZOO_STEPS, "batch_size": ZOO_BATCH, "local_lr": 0.05},
        "execution": {"seed": 0},
    }
    for section, over in sections.items():
        d[section] = {**d.get(section, {}), **over}
    return api.ExperimentSpec.from_dict(d)


def forward_calls(cfg) -> dict:
    """Kernels 6-8's calls in one forward (or prefill) of ``cfg``: kernel 6
    two times a block (four in an attention block with qwen3's q/k norm,
    three in whisper's ``dec`` block with its ``lnx``) plus once (the final
    norm), kernel 7 once an attention block (``moe`` and ``cross_attn``
    blocks and ``shared_attn`` invocations included; twice a ``dec`` block:
    self- and cross-attention), kernel 8 once a mamba2 block; whisper's
    encoder of E ``enc`` blocks adds 2E + 1 norms and E attentions."""
    kinds = list(cfg.block_pattern) * cfg.pattern_repeats()
    self_attn = sum(k in ("attn", "attn_local", "shared_attn", "moe", "dec") for k in kinds)
    e = cfg.encoder_layers
    return {"rmsnorm": 2 * len(kinds) + kinds.count("dec") + (2 * self_attn if cfg.qk_norm else 0)
            + 1 + (2 * e + 1 if e else 0),
            "flash_attention": self_attn + kinds.count("cross_attn") + kinds.count("dec") + e,
            "ssd_scan": kinds.count("mamba2")}


def train_calls(cfg) -> dict:
    """Kernels 6-8's calls in one training step (``loss_fn`` under a
    gradient): ``forward_calls``, and with ``cfg.remat == "full"`` the
    decoder's pattern groups once more, recomputed in the backward
    (``models.remat``); whisper's encoder and the final norm are not
    recomputed (the reference's encoder scan has no checkpoint)."""
    calls = forward_calls(cfg)
    if cfg.remat != "full":
        return calls
    e = cfg.encoder_layers
    return {"rmsnorm": 2 * calls["rmsnorm"] - 1 - (2 * e + 1 if e else 0),
            "flash_attention": 2 * calls["flash_attention"] - e,
            "ssd_scan": 2 * calls["ssd_scan"]}


def zoo_launches_per_round(cfg, c: int, r: int = ZOO_STEPS) -> dict:
    """Kernels 6-8's launches in one zoo round of C slots and R local steps
    (``train_calls`` a step).  client_parallel: the first local step
    runs the C clients on the shared parameters, one launch a call (the
    vmapped axis folds into the rows / B); later steps have diverged
    parameters, and kernel 6's vmap rule loops over the clients' norm
    scales (C launches a call) while kernels 7 and 8 still fold.
    cohort_sequential: one client at a time, every call once a step."""
    calls = train_calls(cfg)
    if cfg.round_mode == "cohort_sequential":
        return {k: v * r * c for k, v in calls.items()}
    return {"rmsnorm": calls["rmsnorm"] * (1 + (r - 1) * c),
            "flash_attention": calls["flash_attention"] * r, "ssd_scan": calls["ssd_scan"] * r}


def zoo_run(torch, api, kernels, label: str, spec, extra: dict | None = None):
    """One zoo run through ``api.run(spec)`` (the GPU by default): kernel
    launches exact (kernels 6-8 every round, plus ``extra`` a run), every
    bf16 kernel-7 launch on the tensor cores, finite losses and parameters,
    cohorts within C.  Returns (History, launches)."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa

    built = api.build(spec)
    cfg, rs = built.arch_config, built.round_spec
    check(built.device.type == "cuda", f"{label}: default device is {built.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    fa.flash_attention.launches_tc = 0
    hist = api.run(spec, built=built)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rounds = spec.federation.rounds
    per_round = zoo_launches_per_round(cfg, rs.cohort, rs.local_steps)
    want = {k: 0 for k in counts}
    want.update({k: rounds * v for k, v in per_round.items()})
    want.update(extra or {})
    check(counts == want, f"{label}: kernel launches {counts}, expected {want}")
    if cfg.param_dtype == torch.bfloat16:
        check(fa.flash_attention.launches_tc == counts["flash_attention"],
              f"{label}: {fa.flash_attention.launches_tc} of {counts['flash_attention']} "
              "kernel-7 launches on the tensor cores")
    check(len(hist.train_loss) == rounds and all(math.isfinite(x) for x in hist.train_loss),
          f"{label}: loss {hist.train_loss}")
    check(all(0 <= c <= rs.cohort for c in hist.cohort_size) and sum(hist.cohort_size) > 0,
          f"{label}: cohorts {hist.cohort_size}")
    for leaf in _leaves(hist.final_params):
        check(bool(np.isfinite(leaf).all()), f"{label}: non-finite parameters")
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(leaf.size for leaf in _leaves(hist.final_params))
    print(f"{label}: {n_params:,} parameters ({cfg.param_dtype}, {cfg.n_layers} blocks, "
          f"{cfg.round_mode}) N={built.dataset.n_clients} C={rs.cohort} R={rs.local_steps} "
          f"B={rs.local_batch} S={ZOO_SEQ} rounds={rounds}: wall_s={hist.wall_time_s:.3f} "
          f"loss {[round(x, 4) for x in hist.train_loss]} cohort={hist.cohort_size} "
          f"dropped={hist.cohort_dropped} peak_mem_gb={peak:.2f} launches a round "
          f"{ {k: v for k, v in per_round.items() if v} } (all {rounds} rounds: "
          f"{ {k: v for k, v in counts.items() if v} }; kernel 7 on the tensor cores "
          f"{fa.flash_attention.launches_tc})", flush=True)
    return hist, counts


ZOO_GROUPS = {  # kernel-name substrings -> the profile's groups
    "k6 forward (rmsnorm)": ("rmsnorm",), "k7 forward (flash_fwd)": ("flash_fwd",),
    "k8 forward (ssd_scan)": ("ssd_scan",),
    "GEMMs": ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas"),
    "elementwise": ("elementwise",), "reductions": ("reduce",),
}


def group_kernels(events) -> tuple[dict, dict]:
    """Device µs of the profiler's kernel ``events`` by ``ZOO_GROUPS``' groups,
    and of the kernels outside them by name."""
    split, other = {g: 0.0 for g in ZOO_GROUPS}, {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in ZOO_GROUPS.items() if any(k in name for k in keys)), None)
        if group is None:
            other[e.key] = other.get(e.key, 0.0) + e.self_device_time_total
        else:
            split[group] += e.self_device_time_total
    return split, other


def _profiled_round(torch, segment, state):
    """One round under torch.profiler with a ``record_function`` range
    around each of kernels 6-8's backwards (set for this measurement only).
    Returns (state, wall s, {group: device µs}, {backward: (device µs,
    calls)}, launches, the kernels outside the groups by name)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd_scan as ssd

    ranges = {"k6 backward": rms._RMSNorm, "k7 backward": fa._FlashAttention,
              "k8 backward": ssd._SSDScan}
    saved = {name: cls.backward for name, cls in ranges.items()}

    def ranged(name, fn):
        def backward(ctx, *grads):
            with record_function(f"zoo::{name}"):
                return fn(ctx, *grads)
        return staticmethod(backward)

    try:
        for name, cls in ranges.items():
            cls.backward = ranged(name, saved[name])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = segment(state, 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, cls in ranges.items():
            cls.backward = saved[name]
    # A range's own "kernel" is its span on the device timeline (queueing
    # included): count only the kernels its ops launched.
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    back = {name: [0.0, 0] for name in ranges}
    for e in prof.events():
        if e.device_type == cpu and e.name.startswith("zoo::"):
            acc = back[e.name[len("zoo::"):]]
            acc[0] += sum(c.device_time_total for c in e.cpu_children)
            acc[1] += 1
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0
               and not e.key.startswith("zoo::")]
    split, other = group_kernels(kernels)
    return (state, wall, split, {k: tuple(v) for k, v in back.items()},
            sum(e.count for e in kernels), other)


def zoo_round_profile(torch, api, label: str, spec, card: str) -> None:
    """One zoo round of ``spec`` alone (its segment, after a warm-up round),
    with the stacked layers taken apart by one ``torch.unbind`` a leaf (the
    model's way) and, for comparison, by indexing one layer at a time (the
    way before: each layer's gradient is a zero-filled copy of its whole
    stack, summed over the layers): the host-clock wall seconds of one
    round each.  Then one round
    of each under torch.profiler: launches, the device's busy share, and
    the device time of kernels 6-8's forwards, of their PyTorch backwards
    (kernel 6's closed form, kernel 7's ``attention_backward``, kernel 8's
    ``vjp`` of the plain chunked scan: the kernels launched inside a
    ``record_function`` range around each ``backward``), of the GEMMs and
    of the elementwise kernels."""
    from repro_torch.api import runner
    from repro_torch.models import transformer

    built = api.build(spec)
    segment, state = runner._zoo_segment_and_state(built)
    state = segment(state, 1)  # warm-up round
    unbind = transformer._unstack

    def index(tree, reps):
        return [transformer._rep(tree, r) for r in range(reps)]

    walls = {}
    try:
        for way in ("unbind", "index"):
            transformer._unstack = unbind if way == "unbind" else index
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = segment(state, 1)
            torch.cuda.synchronize()
            walls[way] = time.perf_counter() - t0
        ZOO_ROUND_S[label] = walls["unbind"]
        print(f"zoo profile {label} ({card}): wall s a round, stacked layers by one unbind "
              f"{walls['unbind']:.4f} against indexing a layer at a time {walls['index']:.4f} "
              "(one round each, outside the profiler)", flush=True)
        # The model's way alone under the profiler (the index way's profiled
        # round was cut to make room for the model_axis phase).
        for way in ("unbind",):
            transformer._unstack = unbind
            state, wall, split, back, launches, other = _profiled_round(torch, segment, state)
            total = sum(split.values()) + sum(other.values())
            if not total:
                print(f"zoo profile {label}: the profiler recorded no kernel time (not measured)")
                continue
            print(f"zoo profile {label}, layers by {way}, one round under the profiler: "
                  f"wall_s={wall:.4f} kernel_s={total / 1e6:.4f} busy_share={total / 1e6 / wall:.3%} "
                  f"launches={launches}", flush=True)
            for group, us in split.items():
                print(f"  {us / 1e3:10.3f} ms  {us / total:6.1%}  {group}")
            print(f"  {sum(other.values()) / 1e3:10.3f} ms  {sum(other.values()) / total:6.1%}  "
                  f"other kernels: " + ", ".join(
                      f"{k[:60]} {v / 1e3:.3f} ms" for k, v in sorted(other.items(), key=lambda kv: -kv[1])[:4]))
            for name, (us, calls) in back.items():
                print(f"  {us / 1e3:10.3f} ms  {us / total:6.1%}  {name} (PyTorch, {calls} calls: the "
                      f"kernels launched inside its range)")
    finally:
        transformer._unstack = unbind


def zoo_agreement(torch, api, np, arch: str = "smollm-360m", kwargs: dict = AGREE_KW,
                  what: str = "2-layer full-width smollm-360m") -> None:
    """One f32 zoo round of ``arch`` (``ArchConfig.reduced(**kwargs)``; by
    default a 2-layer smollm-360m at full width: d_model 960, 15/5 heads,
    d_ff 2560, vocab 49,152) on the card and on the CPU from one
    ``ReplaySource`` (the draws of a CPU ``PhiloxSource``, initial weights
    from a CPU generator): equal cohorts, losses within 1e-5, parameters
    within 1e-4 of each leaf's largest entry."""
    from repro_torch.models import transformer
    from repro_torch.fed.tasks import params_to_numpy
    from repro_torch.rng import PhiloxSource, ReplaySource

    spec = zoo_spec(api, arch, rounds=1, clients=8, budget=2, cohort=3, kwargs=kwargs)
    built = api.build(spec, "cpu")
    n, rs = built.dataset.n_clients, built.round_spec
    src = PhiloxSource(3, "cpu")
    tables = dict(uniforms=src.isp_uniforms(0, n)[None].numpy(),
                  priorities=src.cohort_priorities(0, n)[None].numpy(),
                  batch_idx=src.batch_indices(0, built.dataset.sizes, rs.local_steps,
                                              rs.local_batch)[None].numpy())
    init = params_to_numpy(transformer.init_params(
        built.arch_config, torch.Generator().manual_seed(4), "cpu"))
    t0 = time.perf_counter()
    cpu = api.run(spec, "cpu", random_source=ReplaySource(init, **tables))
    cpu_s = time.perf_counter() - t0
    dev = api.build(spec).device  # the default: the GPU
    gpu = api.run(spec, random_source=ReplaySource(init, device=dev, **tables))
    check(gpu.cohort_size == cpu.cohort_size and gpu.cohort_dropped == cpu.cohort_dropped,
          f"{arch} zoo agreement: cohorts {gpu.cohort_size} against {cpu.cohort_size}")
    check(abs(gpu.train_loss[0] - cpu.train_loss[0]) <= 1e-5 * abs(cpu.train_loss[0]),
          f"{arch} zoo agreement: loss {gpu.train_loss} against {cpu.train_loss}")
    worst = 0.0
    for g, c in zip(_leaves(gpu.final_params), _leaves(cpu.final_params)):
        scale = max(float(np.abs(c).max()), 1e-30)
        worst = max(worst, float(np.abs(g - c).max()) / scale)
    check(worst <= 1e-4, f"{arch} zoo agreement: parameters off the CPU's by {worst:.3g} of a leaf")
    print(f"zoo agreement: {what}, f32, one round ({built.arch_config.round_mode}, C=3, R=2): "
          f"card == CPU on one replayed source (cohort {gpu.cohort_size}, loss "
          f"{gpu.train_loss[0]:.6f} / {cpu.train_loss[0]:.6f}, parameters within {worst:.3g} of "
          f"each leaf's scale; CPU round {cpu_s:.1f} s)", flush=True)


def zoo_resume(torch, api, np, spec) -> None:
    """``spec`` (with ``ckpt_every=1``) stopped after one segment and resumed
    through ``api.run`` and a fresh ``CheckpointManager``: History and final
    parameters bitwise the uninterrupted card run."""
    import shutil
    import tempfile

    from repro_torch.api import runner
    from repro_torch.checkpoint import CheckpointManager, config_fingerprint
    from repro_torch.fed.state import run_segmented

    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_ckpt_")
    try:
        fp = config_fingerprint(spec)
        full = api.run(spec)
        segment, st0 = runner._zoo_segment_and_state(api.build(spec))
        pre = run_segmented(st0, spec.federation.rounds, segment, ckpt_every=1,
                            manager=CheckpointManager(root, fingerprint=fp), max_segments=1)
        check(pre.round == 1, f"zoo resume: preempted at round {pre.round}")
        resumed = api.run(spec, ckpt_manager=CheckpointManager(root, fingerprint=fp))
        for field in ("train_loss", "cohort_size", "cohort_dropped", "deadline_dropped"):
            check(getattr(resumed, field) == getattr(full, field),
                  f"zoo resume: {field} differs from the uninterrupted run")
        for a, b in zip(_leaves(resumed.final_params), _leaves(full.final_params)):
            check(np.array_equal(a, b), "zoo resume: final parameters differ")
        size = sum(f.stat().st_size for f in Path(root).iterdir())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"zoo resume: preempted after round 1 of {spec.federation.rounds}, resumed through a "
          f"fresh manager: History and final parameters bitwise the uninterrupted card run "
          f"(checkpoint directory {size} bytes)", flush=True)


def fed_lm_on_card(torch, kernels, out: Path) -> dict:
    """``repro_torch.examples.fed_lm`` on the card, rounds cut: ``--model
    tiny`` and ``--model zoo`` with its default ``--archs`` (the four
    families of Figure 5: smollm, moe, ssm, xlstm; the task stack in oracle
    mode: every client trains, kernel 1 once a round; the zoo tasks'
    forwards launch kernels 6-8, one launch a call with the clients vmapped
    over shared parameters), then ``bench.tables``: its fig5 rows for
    either JSON, every run present and finite.  Returns the launches."""
    import re

    from repro_torch.bench import tables
    from repro_torch.configs import get_config
    from repro_torch.examples import fed_lm

    rounds, samplers = 5, ["uniform_isp", "kvib"]  # 10 before PR 29, 20 before PR 28
    argv = ["--rounds", str(rounds), "--samplers", *samplers]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tiny = fed_lm.main(argv + ["--out", str(out / "fed_lm.json")])
    tiny_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo = fed_lm.main(argv + ["--out", str(out / "zoo" / "fed_lm.json"), "--model", "zoo"])
    zoo_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(tiny["config"]["device"] is None and zoo["config"]["device"] is None,
          "fed_lm: not run on the default device")
    runs = len(samplers) * rounds
    archs = list(fed_lm.ZOO_ARCHS)
    check(archs == ["smollm", "moe", "ssm", "xlstm"], f"fed_lm: default archs {archs}")
    want = {k: 0 for k in counts}
    want["fused_multi_weighted_agg"] = (1 + len(archs)) * runs  # tiny, then each arch
    for arch in archs:
        name, over = fed_lm.ZOO_ARCHS[arch]
        for k, v in train_calls(get_config(name).reduced(**over)).items():
            want[k] += v * runs
    check(counts == want, f"fed_lm: kernel launches {counts}, expected {want}")
    rows = {name: derived for name, _, derived in tables.main(["--results-dir", str(out)])
            if name.startswith("fig5")}
    rows.update({name: derived for name, _, derived in tables.table_fed_lm(str(out / "zoo"))})
    want_rows = [f"fig5_lm_{s}" for s in samplers] + [
        f"fig5_lm_{s}/{a}" for s in samplers for a in archs]
    check(sorted(rows) == sorted(want_rows), f"fed_lm: fig5 rows {sorted(rows)}")
    for name, derived in rows.items():
        nums = re.findall(r"[-+]?(?:\d+\.\d*|\d+|nan|inf)", derived)
        check(nums and all(math.isfinite(float(x)) for x in nums), f"fed_lm: row {name}: {derived}")
    walls = {k: round(v["wall_s"], 4) for res in (tiny, zoo) for k, v in res["runs"].items()}
    print(f"fed_lm on the card, {rounds} rounds a spec: --model tiny {tiny_s:.2f} s, --model zoo "
          f"(--archs {' '.join(archs)}) {zoo_s:.2f} s; wall s a spec {walls}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return counts


def zoo_phase(torch, card: str) -> dict:
    """The zoo round on the card through ``repro_torch.api.run(spec)`` (no
    device argument): (n) smollm-360m at full width and depth
    (client_parallel, N=32, K=6, C=8, 3 rounds); (o) zamba2-1.2b at full
    width and depth (client_parallel, N=32, K=6, C=8, 2 rounds); (p)
    gemma2-27b at full width cut to one (attn_local, attn) pattern
    (cohort_sequential, its config's mode; N=32, K=3, C=4, 2 rounds): each
    with exact per-round launches of kernels 6-8, every kernel-7 launch on
    the tensor cores.  Then at reduced width (the 4-block f32 hybrid):
    int8 + error feedback (kernel 4 once a round) and ``sampler_axis``
    (kernel 5 five times a round); a 2-layer full-width smollm round in f32
    on the card and on the CPU; a preempted and resumed zoo run, bitwise;
    the fed_lm example and its fig5 rows; and one round of (n) and of (o)
    under the profiler.  Returns the launches."""
    phase("zoo")
    import numpy as np

    from repro_torch import api, kernels

    launches = {k: 0 for k in kernels.launch_counts()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    runs = {label: zoo_spec(api, arch, kwargs=kw, rounds=t, clients=n, budget=k, cohort=c)
            for label, (arch, kw, t, n, k, c) in ZOO_RUNS.items()}
    for label, spec in runs.items():
        hist, counts = zoo_run(torch, api, kernels, label, spec)
        add(counts)
        del hist
        torch.cuda.empty_cache()
    hyb = dict(vocab=512, **HYBRID_4)
    small = dict(rounds=3, clients=16, budget=3, cohort=4, kwargs=hyb)
    _, counts = zoo_run(
        torch, api, kernels, "(q) zamba2 4-block hybrid int8+EF",
        zoo_spec(api, "zamba2-1.2b", compression={"delta_dtype": "int8"}, **small),
        extra={"fused_dequant_cohort_agg": 3})
    add(counts)
    _, counts = zoo_run(
        torch, api, kernels, "(r) zamba2 4-block hybrid sampler_axis",
        zoo_spec(api, "zamba2-1.2b", execution={"sampler_axis": "data"}, **small),
        extra={"waterfill_level_stats": LADDER_PASSES * 3})
    add(counts)
    zoo_agreement(torch, api, np)
    zoo_resume(torch, api, np, zoo_spec(
        api, "zamba2-1.2b", execution={"ckpt_every": 1},
        fault={"availability": "bernoulli", "availability_kwargs": {"q": 0.8}, "async_buffer": 2},
        **small))
    add(fed_lm_on_card(torch, kernels, ROOT / "results" / "torch" / "smoke"))
    kernels.reset_launch_counts()  # the profiled rounds are measurements, not the path
    for label in ("(n) smollm-360m", "(o) zamba2-1.2b"):
        spec = with_sections(api, runs[label], federation={"rounds": 5},
                             sampler={"kwargs": {"horizon": 5}})
        zoo_round_profile(torch, api, label, spec, card)
        torch.cuda.empty_cache()
    return launches


# -- the moe and xlstm families --------------------------------------------------

# Serving: ServeEngine at batch 8, pages of 16, 64 new tokens, bf16 at the
# configs' widths; (w) qwen3 cut to 2 of 94 layers, (x) arctic to 1 of 35,
# (y) xlstm-125m whole through the launcher at prompt 128.
FAMILY_SERVE = dict(batch=8, prompt_len=512, new_tokens=64, page_size=16)
SERVE_Y = ["--arch", "xlstm-125m", "--batch", "8", "--prompt-len", "128",
           "--new-tokens", "64", "--page-size", "16"]
# (aa) trains at local_lr 2e-4: xlstm-125m's gradient norm at its random
# init is 3.4e4 in both packages (seq 64, f32), and SGD at 5e-3 or more
# diverges to non-finite parameters within a round in the port and in the
# reference alike.
FAMILY_RUNS = {  # label: (arch, reduced() kwargs or None for the full config, rounds, N, K, C,
    # spec sections)
    "(z) qwen3-moe one layer": ("qwen3-moe-235b-a22b", dict(
        n_layers=1, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936,
        head_dim=128, n_experts=128, top_k=8, moe_d_ff=1536, capacity_factor=1.25,
        param_dtype="bfloat16"), 2, 32, 3, 4, {}),
    # R = 1: its recurrences launch a token at a time (~90,000 kernels a
    # local step), and the profiler's trace of them is the phase's longest wait.
    "(aa) xlstm-125m": ("xlstm-125m", None, 1, 32, 6, 8, {"federation": {"local_lr": 2e-4,
                                                                        "local_steps": 1}}),
    "(ab) arctic reduced": ("arctic-480b", {}, 2, 32, 3, 4, {}),
}
FAMILY_AGREE = ("qwen3-moe-235b-a22b", "arctic-480b", "xlstm-125m")  # reduced, f32


class RouteStats:
    """Counts the routed assignments ``models.moe.route`` keeps and drops,
    and the experts that hold at least one kept assignment, a call (one
    ``moe`` block of one pass), while installed (``moe.route`` replaced for
    a measurement only; the counts stay on the device until ``read``)."""

    def __init__(self, moe_mod):
        self.moe, self.orig, self.parts = moe_mod, moe_mod.route, []

    def __enter__(self):
        def route(*a, **kw):
            out = self.orig(*a, **kw)
            top_idx, mask, keep = out[2], out[3], out[-1]
            used = mask.new_zeros(mask.shape).scatter(1, top_idx, keep.to(mask.dtype)).amax(0).sum()
            self.parts.append((keep.sum(), keep.numel(), used))
            return out

        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def read(self) -> tuple[int, int, int]:
        """(kept assignments, all assignments, experts used summed over the
        calls) since the last read."""
        kept = sum(int(k) for k, _, _ in self.parts)
        total = sum(n for _, n, _ in self.parts)
        used = sum(int(u) for _, _, u in self.parts)
        self.parts = []
        return kept, total, used


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def moe_decode_bound(cfg, params, batch: int, positions: range, used: int) -> tuple[float, str]:
    """The bytes a decode step of an MoE model must move, over the HBM
    rate, in ms: the experts this run routed a kept assignment to (``used``,
    summed over the steps' ``moe`` calls, over the steps), every other
    weight once (the embedding's ``batch`` rows unless it is also the
    head), each attention layer's K and V up to the step's position, the
    f32 logits written.  Returns (ms, the terms in GB a step)."""
    steps = len(positions)
    item = next(t for n, t in _named_leaves(params) if n.endswith("/w_gate")).element_size()
    expert = 3 * cfg.d_model * cfg.moe_d_ff * item
    routed = used * expert / steps
    rest = 0
    for name, t in _named_leaves(params):
        if name.rsplit("/", 1)[-1] in EXPERT_LEAVES:
            continue
        if name == "/embed" and not cfg.tie_embeddings:
            rest += batch * cfg.d_model * t.element_size()
        else:
            rest += t.numel() * t.element_size()
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    kv = sum(2 * batch * pos * cfg.n_kv_heads * hd * item for pos in positions) * cfg.n_layers / steps
    logits = batch * cfg.vocab * 4
    total = routed + rest + kv + logits
    terms = (f"routed experts {routed / 1e9:.3f} GB ({used / steps / cfg.n_layers:.2f} of "
             f"{cfg.n_experts} experts a layer, {expert / 1e6:.1f} MB each), other weights "
             f"{rest / 1e9:.3f} GB, K/V {kv / 1e9:.4f} GB, logits {logits / 1e9:.4f} GB")
    return total / HBM_BYTES_PER_S * 1e3, terms


def family_serve(torch, kernels, label: str, cfg, seed: int, card: str) -> dict:
    """One served model through ``ServeEngine`` (bf16, the card): prefill
    8 x 512, 63 decode steps, the exact launches of kernels 6 and 7 (kernel
    6 ``forward_calls`` a pass, kernel 7 once an attention block in the
    prefill), every kernel-7 launch on the tensor cores.  Then, for the
    measurement only, the share of routed assignments the capacity dropped
    in a prefill and in its decode steps, and 8 decode steps under the
    profiler (launches a step, busy share).  Returns the launches."""
    from repro_torch.models import moe, transformer
    from repro_torch.serve import ServeEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen)
    n_params = transformer.param_count(params)
    g = FAMILY_SERVE
    eng = ServeEngine(cfg, params, batch=g["batch"], max_seq=g["prompt_len"] + g["new_tokens"],
                      page_size=g["page_size"], seed=seed + 1)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab, (g["batch"], g["prompt_len"]), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    from repro_torch.kernels import flash_attention as fa

    fa.flash_attention.launches_tc = 0
    t0 = time.perf_counter()
    eng.start(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_counts = kernels.launch_counts()
    eng.step(g["new_tokens"] - 1)
    counts = kernels.launch_counts()
    per_pass = forward_calls(cfg)
    want = {"rmsnorm": per_pass["rmsnorm"] * g["new_tokens"],
            "flash_attention": per_pass["flash_attention"]}
    check({k: prefill_counts[k] for k in want} == {"rmsnorm": per_pass["rmsnorm"],
                                                    "flash_attention": per_pass["flash_attention"]},
          f"{label}: prefill launches {prefill_counts}")
    _serve_checks(torch, label, eng, counts, want, g["new_tokens"])
    _tensor_core_check(label, counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    decode_s, tps = eng.decode_seconds, eng.tokens_per_sec()
    # Measurements, outside the counted run.
    drops = bound = ""
    if cfg.n_experts:
        with RouteStats(moe) as stats:
            eng.start(prompts)
            kept_p, all_p, _ = stats.read()
            eng.step(g["new_tokens"] - 1)
            kept_d, all_d, used_d = stats.read()
        drops = (f" capacity drops: prefill {1 - kept_p / all_p:.4%} of {all_p} assignments "
                 f"(cap {moe.capacity(cfg, g['batch'] * g['prompt_len'])} a expert), decode "
                 f"{1 - kept_d / all_d:.4%} of {all_d} (cap {moe.capacity(cfg, g['batch'])})")
        steps = range(g["prompt_len"] + 1, g["prompt_len"] + g["new_tokens"])
        bound_ms, terms = moe_decode_bound(cfg, eng.params, g["batch"], steps, used_d)
    t0 = time.perf_counter()
    eng.start(prompts)
    torch.cuda.synchronize()
    warm_prefill_s = time.perf_counter() - t0
    prof = profile_kernels(torch, lambda: eng.step(8), f"{label} decode", "8 decode steps", top=6)
    per_step = sum(n for _, n in prof.values()) / 8 if prof else float("nan")
    if cfg.n_experts:
        step_ms = decode_s / (g["new_tokens"] - 1) * 1e3
        kernel_ms = sum(us for us, _ in prof.values()) / 8 / 1e3 if prof else float("nan")
        bound = (f"; decode bound {bound_ms:.4f} ms a step ({terms}; the dense dispatch reads "
                 f"all {cfg.n_experts} experts a layer): the step {step_ms:.4f} ms is "
                 f"{step_ms / bound_ms:.2f}x it, its kernel time under the profiler "
                 f"{kernel_ms:.4f} ms {kernel_ms / bound_ms:.2f}x; tokens/s at the bound "
                 f"{g['batch'] / bound_ms * 1e3:.1f}")
    print(f"{label} ({card}): {n_params:,} params bf16, {cfg.n_layers} of its layers, batch "
          f"{g['batch']}, prompt {g['prompt_len']}, {g['new_tokens']} new tokens: init+copy "
          f"{init_s:.2f} s, prefill_s={prefill_s:.4f} (warm {warm_prefill_s:.4f}) "
          f"decode_s={decode_s:.4f} ({g['new_tokens'] - 1} steps) tokens_per_sec={tps:.1f} "
          f"launches a decode step "
          f"(profiler) {per_step:.0f} peak_mem_gb={peak:.2f} kernel launches "
          f"{ {k: v for k, v in counts.items() if v} } (prefill "
          f"{ {k: v for k, v in prefill_counts.items() if v} }){drops}{bound}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return counts


def xlstm_serve(torch, kernels, card: str) -> dict:
    """(y) ``python -m repro_torch.launch.serve --arch xlstm-125m`` (whole,
    bf16, the card): prefill 8 x 128, an sLSTM block as one decode cell a
    token after one ``ln1`` norm over the prompt, an mLSTM block its
    ``ln1`` and inner norm once over the prompt, so kernel 6 runs
    L/2 (1 + S) + L + 1 = 787 times in the prefill and 2L + 1 = 25 times a
    decode step; kernel 7 never.  Then 8 decode steps under the profiler."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = serve.main(SERVE_Y)
    counts = kernels.launch_counts()
    eng = out["engine"]
    cfg = eng.cfg
    n_params = transformer.param_count(eng.params)
    check((cfg.name, cfg.n_layers, cfg.d_model, n_params) == ("xlstm-125m", 12, 768, 134_337_840),
          f"(y): not xlstm-125m whole: {cfg}, {n_params}")
    s, new = int(SERVE_Y[5]), int(SERVE_Y[7])
    per_step = 2 * cfg.n_layers + 1
    reps = cfg.pattern_repeats()
    prefill = reps * cfg.block_pattern.count("slstm") * (1 + s) + reps * 2 + 1
    check(out["prefill_launches"]["rmsnorm"] == prefill == 787,
          f"(y): prefill launches {out['prefill_launches']}")
    _serve_checks(torch, "(y)", eng, counts, {"rmsnorm": prefill + per_step * (new - 1)}, new)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prompts = torch.randint(0, cfg.vocab, (eng.batch, s), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    eng.start(prompts)
    prof = profile_kernels(torch, lambda: eng.step(8), "(y) decode", "8 decode steps", top=6)
    launches = sum(n for _, n in prof.values()) / 8 if prof else float("nan")
    print(f"(y) xlstm-125m serve ({card}): {n_params:,} params bf16, batch 8, prompt {s}, {new} new "
          f"tokens: prefill_s={out['prefill_s']:.4f} decode_s={out['decode_s']:.4f} "
          f"tokens_per_sec={out['tokens_per_sec']:.1f} launches a decode step (profiler) "
          f"{launches:.0f} peak_mem_gb={peak:.2f} kernel launches "
          f"{ {k: v for k, v in counts.items() if v} } (prefill {out['prefill_launches']['rmsnorm']} "
          f"of kernel 6)", flush=True)
    del eng, out
    torch.cuda.empty_cache()
    return counts


def device_split(torch, fn) -> tuple:
    """``fn()`` under torch.profiler with the CUDA activity alone (no CPU
    events: a round of ~145,000 launches would take minutes of
    post-processing with them).  Returns (wall s, launches, {group: device
    µs}, kernel µs in all) with ``ZOO_GROUPS``' groups."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    split, other = group_kernels(kernels)
    return (wall, sum(e.count for e in kernels), split,
            sum(split.values()) + sum(other.values()))


def family_round(torch, api, kernels, label: str, spec, card: str) -> dict:
    """A zoo run (``zoo_run``: exact launches of kernels 6-8 a round), then
    one round of a fresh run of the same spec under the profiler (the zoo
    run has warmed its shapes up): wall seconds, launches and the device's
    busy share."""
    hist, counts = zoo_run(torch, api, kernels, label, spec)
    rounds = len(hist.train_loss)
    del hist
    from repro_torch.api import runner

    segment, state = runner._zoo_segment_and_state(api.build(spec))
    wall, launches, split, total = device_split(torch, lambda: segment(state, 1))
    busy = f"{total / 1e6 / wall:.3%}" if total else "not measured"
    top = ", ".join(f"{g} {us / 1e3:.1f} ms" for g, us in split.items() if us)
    print(f"{label} one round under the profiler ({card}): wall_s={wall:.4f} launches={launches} "
          f"kernel_s={total / 1e6:.4f} busy_share={busy} ({top}); the zoo run's {rounds} rounds "
          f"above include its first use of each shape", flush=True)
    del state, segment
    torch.cuda.empty_cache()
    return counts


def family_agreement(torch, api, np) -> None:
    """The three families reduced, f32: served on the card and on the CPU
    from the same weights (4 x 40 prompts, 8 decode steps) with the same
    greedy tokens and logits within 1e-4; one zoo round on the card and on
    the CPU from one replayed source (counts exact, loss within 1e-5,
    parameters within 1e-4 of each leaf's scale); a reduced qwen3 zoo spec
    run twice on the card, bitwise equal, and preempted and resumed,
    bitwise the uninterrupted run."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    for name in FAMILY_AGREE:
        t0 = time.perf_counter()
        cfg = get_config(name).reduced()
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompts = torch.randint(0, cfg.vocab, (4, 40), generator=torch.Generator().manual_seed(1))
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg, params, batch=4, max_seq=48, page_size=16, device=dev)
            eng.start(prompts)
            eng.step(7)
            runs[dev] = (eng.last_logits.cpu(), eng.generated().cpu())
        (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
        check(torch.equal(g_cpu, g_gpu), f"{name} served tokens differ: GPU {g_gpu.tolist()} "
              f"CPU {g_cpu.tolist()}")
        torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-4, atol=1e-4)
        print(f"family agreement {name} reduced f32: served GPU == CPU greedy tokens "
              f"{tuple(g_gpu.shape)}, last logits max_abs_diff={float((l_gpu - l_cpu).abs().max()):.3g} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        zoo_agreement(torch, api, np, name, {}, f"{name} reduced")

    t0 = time.perf_counter()
    spec = zoo_spec(api, "qwen3-moe-235b-a22b", rounds=3, clients=16, budget=3, cohort=4,
                    kwargs={"vocab": 512}, execution={"ckpt_every": 1})
    a, b = api.run(spec), api.run(spec)
    check(a.train_loss == b.train_loss and a.cohort_size == b.cohort_size,
          "qwen3 reduced: two card runs differ in their History")
    for x, y in zip(_leaves(a.final_params), _leaves(b.final_params)):
        check(np.array_equal(x, y), "qwen3 reduced: two card runs differ in their parameters")
    print(f"qwen3 reduced zoo spec ({spec.federation.rounds} rounds, C=4): two card runs bitwise "
          f"equal (loss {[round(x, 6) for x in a.train_loss]}; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    zoo_resume(torch, api, np, spec)


def zoo_families_phase(torch, card: str) -> dict:
    """The moe and xlstm families on the card: serving (w) qwen3-moe at full
    width, 2 of 94 layers, (x) arctic-480b at full width, 1 of 35 layers,
    (y) xlstm-125m whole through the launcher; zoo rounds through
    ``api.run(spec)`` (seq 64, local batch 2, R = 2): (z) qwen3-moe full
    width one layer (cohort_sequential, N = 32, K = 3, C = 4), (aa)
    xlstm-125m whole (client_parallel, N = 32, K = 6, C = 8, R = 1), (ab) arctic
    reduced (its full-width round does not fit one card); each with exact
    launches of kernels 6 and 7; then the reduced families' agreement of
    card and CPU and a reduced qwen3 spec's bitwise repeat and resume.
    Returns the launches."""
    phase("zoo_families")
    import dataclasses

    import numpy as np

    from repro_torch import api, kernels
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    launches = {k: 0 for k in kernels.launch_counts()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    laps = {}

    def lap(label, t0):
        laps[label] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    add(family_serve(torch, kernels, "(w) qwen3-moe-235b-a22b",
                     dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=2), 21, card))
    lap("(w)", t0)
    t0 = time.perf_counter()
    add(family_serve(torch, kernels, "(x) arctic-480b",
                     dataclasses.replace(get_config("arctic-480b"), n_layers=1), 22, card))
    lap("(x)", t0)
    t0 = time.perf_counter()
    add(xlstm_serve(torch, kernels, card))
    lap("(y)", t0)
    for label, (arch, kw, t, n, k, c, sections) in FAMILY_RUNS.items():
        t0 = time.perf_counter()
        spec = zoo_spec(api, arch, kwargs=kw, rounds=t, clients=n, budget=k, cohort=c, **sections)
        add(family_round(torch, api, kernels, label, spec, card))
        lap(label.split()[0], t0)
    t0 = time.perf_counter()
    family_agreement(torch, api, np)
    lap("agreement", t0)
    print(f"zoo_families phase: {time.perf_counter() - t_phase:.1f} s (seconds a step: "
          f"{json.dumps(laps)})", flush=True)
    return launches


# -- the vlm and audio families --------------------------------------------------

# Serving through the model-level API (the engine refuses frontend archs, as
# the reference's does): ``transformer.prefill`` at batch 8 with pages of 16,
# then 63 greedy ``decode_step``s, bf16 at the configs' widths and depths;
# the frontend embeddings standard normal f32 from a seeded generator.
FRONTEND_SERVE = {  # label: (arch, prompt length, the gates' value after init or None)
    "(ac) whisper-small": ("whisper-small", 64, None),
    "(ad) llama-3.2-vision-11b": ("llama-3.2-vision-11b", 512, 0.5),
}
FRONTEND_BATCH, FRONTEND_NEW, FRONTEND_PAGE = 8, 64, 16
# Rounds through ``fed.round.build_round_step`` with ``aux_embeds``: seq 64,
# local batch 2, R = 2, the weights of a K-Vib draw over N = 32 clients, 2
# rounds (the second under the profiler), bf16.  (af) runs the vlm one
# pattern deep (4 attn and 1 cross_attn block, 2.15e9 parameters) at full
# width: its whole cohort_sequential round would hold ~97.8 GB (parameters,
# a training copy, its gradients, the f32 estimate: 9.78e9 x 10 bytes).
FRONTEND_ROUNDS = {  # label: (arch, n_layers or None for the whole model, K, C)
    "(ae) whisper-small": ("whisper-small", None, 6, 8),
    "(af) llama-3.2-vision-11b one pattern": ("llama-3.2-vision-11b", 5, 3, 4),
}
FRONTEND_CLIENTS, FRONTEND_LR, FRONTEND_GATE = 32, 0.02, 0.5


def frontend_inputs(torch, cfg, shape, gen):
    """Tokens of ``shape`` and standard normal f32 frontend embeddings
    (*shape[:-1], frontend_seq, frontend_dim), both from ``gen``."""
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen, device=gen.device)
    aux = torch.randn(*shape[:-1], cfg.frontend_seq, cfg.frontend_dim, generator=gen,
                      device=gen.device)
    return tokens, aux


def set_gates(params, value: float) -> None:
    """The ``cross_attn`` blocks' gates, zero at init (so cross-attention
    changes no logit), set to ``value``."""
    for slot in params["stacks"]:
        if "gate" in slot:
            slot["gate"].fill_(value)


def decode_calls(cfg) -> dict:
    """Kernel 6's calls in one decode step: the decoder's norms of a
    forward (no encoder); kernel 7 never (the cross K/V come from the
    cache, read in plain torch)."""
    e = cfg.encoder_layers
    return {"rmsnorm": forward_calls(cfg)["rmsnorm"] - (2 * e + 1 if e else 0),
            "flash_attention": 0, "ssd_scan": 0}


def greedy(torch, params, cfg, tokens, aux, new: int, kernels=None) -> dict:
    """``transformer.prefill`` of ``tokens`` with ``aux`` (paged, room for
    ``new`` tokens), then ``new - 1`` greedy ``decode_step``s: the
    generated tokens (B, new), the last logits, the prefill's and the
    decode's seconds and (with ``kernels``) the prefill's launches."""
    from repro_torch.models import transformer

    dev = tokens.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    s = tokens.shape[1]
    sync()
    t0 = time.perf_counter()
    logits, caches = transformer.prefill(params, cfg, tokens, aux, max_seq=s + new,
                                         page_size=FRONTEND_PAGE)
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_launches = kernels.launch_counts() if kernels else None
    out = [logits.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(new - 1):
        logits, caches = transformer.decode_step(params, cfg, out[-1], caches, s + i)
        out.append(logits.argmax(-1))
    sync()
    return {"generated": torch.cat(out, 1), "logits": logits, "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0, "prefill_launches": prefill_launches}


def frontend_serve(torch, kernels, label: str, arch: str, prompt_len: int, gate, seed: int,
                   card: str) -> dict:
    """One frontend arch served whole on the card (``greedy``, bf16): the
    exact launches of kernels 6 and 7 (``forward_calls`` in the prefill,
    ``decode_calls`` a decode step), every kernel-7 launch on the tensor
    cores, finite logits; then a second prefill and 8 decode steps under
    the profiler (launches a step, the device's busy share).  Returns the
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen)
    if gate is not None:
        set_gates(params, gate)
    n_params = transformer.param_count(params)
    tokens, aux = frontend_inputs(torch, cfg, (FRONTEND_BATCH, prompt_len), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    fa.flash_attention.launches_tc = 0
    out = greedy(torch, params, cfg, tokens, aux, FRONTEND_NEW, kernels)
    counts = kernels.launch_counts()
    per_pass, per_step = forward_calls(cfg), decode_calls(cfg)
    want = {k: 0 for k in counts}
    want.update({k: per_pass[k] + (FRONTEND_NEW - 1) * per_step[k] for k in per_pass})
    check({k: out["prefill_launches"][k] for k in per_pass} == per_pass,
          f"{label}: prefill launches {out['prefill_launches']}, expected {per_pass}")
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    check(fa.flash_attention.launches_tc == counts["flash_attention"],
          f"{label}: {fa.flash_attention.launches_tc} of {counts['flash_attention']} kernel-7 "
          "launches on the tensor cores")
    gen_tokens = out["generated"]
    check(tuple(gen_tokens.shape) == (FRONTEND_BATCH, FRONTEND_NEW)
          and bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab)).all())
          and bool(torch.isfinite(out["logits"]).all()), f"{label}: bad output")
    peak = torch.cuda.max_memory_allocated() / 1e9
    tps = FRONTEND_BATCH * (FRONTEND_NEW - 1) / out["decode_s"]
    # Measurements, outside the counted run: a warm prefill, then 8 decode
    # steps from its caches.
    s = prompt_len
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = transformer.prefill(params, cfg, tokens, aux, max_seq=s + 9,
                                 page_size=FRONTEND_PAGE)[1]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    tok = gen_tokens[:, :1]

    def steps():
        for i in range(8):
            transformer.decode_step(params, cfg, tok, caches, s + i)

    wall, launches, split, total = device_split(torch, steps)
    busy = f"{total / 1e6 / wall:.3%}" if total else "not measured"
    print(f"{label} serve ({card}): {n_params:,} params bf16, {cfg.n_layers} layers"
          f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, batch "
          f"{FRONTEND_BATCH}, prompt {prompt_len}, frontend {cfg.frontend_seq} x "
          f"{cfg.frontend_dim} f32, {FRONTEND_NEW} new tokens (pages of {FRONTEND_PAGE}"
          f"{f', gates {gate}' if gate is not None else ''}): init {init_s:.2f} s, "
          f"prefill_s={out['prefill_s']:.4f} (warm {warm_s:.4f}) "
          f"decode_s={out['decode_s']:.4f} ({FRONTEND_NEW - 1} steps) tokens_per_sec={tps:.1f} "
          f"peak_mem_gb={peak:.2f} kernel launches "
          f"{ {k: v for k, v in counts.items() if v} } (prefill "
          f"{ {k: v for k, v in out['prefill_launches'].items() if v} }, a decode step "
          f"{ {k: v for k, v in per_step.items() if v} }); 8 decode steps under the profiler: "
          f"launches a step {launches / 8:.0f}, wall_s={wall:.4f} busy_share={busy}", flush=True)
    del params, out, caches
    torch.cuda.empty_cache()
    return counts


def kvib_cohort(torch, sampler, s_state, source, t: int, n: int, c: int):
    """Round t's K-Vib draw over n clients (equal lambda = 1/n) mapped onto
    C slots, as ``launch.train`` draws it: (selection, draw, lam)."""
    from repro_torch.launch.train import draw_cohort

    lam = torch.full((n,), 1.0 / n, device=source.device)
    sel, draw, _ = draw_cohort(sampler, s_state, source, t, lam, c)
    return sel, draw, lam


def frontend_round(torch, kernels, label: str, arch: str, layers, k: int, c: int,
                   card: str) -> dict:
    """Two rounds of ``build_round_step`` with ``aux_embeds`` (the cohort
    and its weights from a K-Vib draw, the sampler updated with the
    round's norms), the second under the profiler: seconds a round,
    launches a round, the device's busy share, peak memory, and the exact
    launches of kernels 6 and 7 (``zoo_launches_per_round``), every
    kernel-7 launch on the tensor cores, finite losses and parameters.
    Returns the launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.samplers import make_sampler
    from repro_torch.fed import round as fed_round
    from repro_torch.fed.cohort import scatter_cohort
    from repro_torch.fed.tasks import tree_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.rng import PhiloxSource

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    params = transformer.init_params(cfg, gen)
    if "cross_attn" in cfg.block_pattern:
        set_gates(params, FRONTEND_GATE)
    n_params = transformer.param_count(params)
    n = FRONTEND_CLIENTS
    sampler = make_sampler("kvib", n=n, budget=k, horizon=2)
    state = {"params": params, "s": sampler.init(dev)}
    source = PhiloxSource(7, dev)
    step = fed_round.build_round_step(cfg, fed_round.RoundSpec(
        cohort=c, local_steps=ZOO_STEPS, local_lr=FRONTEND_LR, local_batch=ZOO_BATCH))
    losses, cohorts = [], []

    def one_round(t):
        sel, draw, lam = kvib_cohort(torch, sampler, state["s"], source, t, n, c)
        tokens, aux = frontend_inputs(torch, cfg, (c, ZOO_STEPS, ZOO_BATCH, ZOO_SEQ + 1), gen)
        new, norms, loss = step(state["params"], tokens[..., :-1], tokens[..., 1:], sel.weights,
                                aux)
        state["s"] = sampler.update(state["s"], draw, scatter_cohort(lam[sel.ids] * norms, sel, n))
        state["params"] = new
        losses.append(loss)
        cohorts.append(sel.valid)

    kernels.reset_launch_counts()
    fa.flash_attention.launches_tc = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    wall, launches, split, total = device_split(torch, lambda: one_round(1))
    counts = kernels.launch_counts()
    per_round = zoo_launches_per_round(cfg, c)
    want = {name: 0 for name in counts}
    want.update({name: 2 * v for name, v in per_round.items()})
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    check(fa.flash_attention.launches_tc == counts["flash_attention"],
          f"{label}: {fa.flash_attention.launches_tc} of {counts['flash_attention']} kernel-7 "
          "launches on the tensor cores")
    loss_vals = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in loss_vals), f"{label}: losses {loss_vals}")
    check(all(bool(torch.isfinite(leaf).all()) for leaf in tree_leaves(state["params"])),
          f"{label}: non-finite parameters")
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = f"{total / 1e6 / wall:.3%}" if total else "not measured"
    top = ", ".join(f"{g} {us / 1e3:.1f} ms" for g, us in split.items() if us)
    print(f"{label} round ({card}): {n_params:,} parameters bf16, {cfg.n_layers} layers"
          f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''} "
          f"({cfg.round_mode}), N={n} K={k} C={c} R={ZOO_STEPS} B={ZOO_BATCH} S={ZOO_SEQ}, aux "
          f"{(c, ZOO_STEPS, ZOO_BATCH, cfg.frontend_seq, cfg.frontend_dim)} f32: round 1 "
          f"{first_s:.4f} s (first use of each shape), round 2 under the profiler wall_s="
          f"{wall:.4f} launches={launches} kernel_s={total / 1e6:.4f} busy_share={busy} ({top}); "
          f"loss {[round(x, 4) for x in loss_vals]} cohorts "
          f"{[int(v.sum()) for v in cohorts]} peak_mem_gb={peak:.2f} kernel launches a round "
          f"{ {name: v for name, v in per_round.items() if v} } (2 rounds: "
          f"{ {name: v for name, v in counts.items() if v} })", flush=True)
    del state, step
    torch.cuda.empty_cache()
    return counts


def frontend_agreement(torch, np) -> None:
    """The card against the CPU, f32, on the same weights and inputs: the
    reduced configs served (4 x 40 prompts, 16 frontend positions, 8 new
    tokens; the vlm's gates at 0.5) with equal greedy tokens and logits
    within 1e-4; a round step of each reduced config in its own mode, and
    of reduced whisper with int8 + error feedback, with the new parameters
    within 1e-4 of each leaf's scale (int8: plus one quantization step of
    the round's movement, where the two devices' scaled deltas straddle a
    rounding boundary); a full-width whisper of one encoder and one decoder
    layer over 1500 frames, prefill logits within 1e-4 (kernel 7's CUDA-core
    kernel bidirectional and cross at S_k = 1500 inside a model)."""
    import dataclasses

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.fed import round as fed_round
    from repro_torch.fed.tasks import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer

    def cuda(tree):
        return tree_map(lambda t: t.cuda(), tree)

    for arch in ("whisper-small", "llama-3.2-vision-11b"):
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        gen = torch.Generator().manual_seed(0)
        params = transformer.init_params(cfg, gen, "cpu")
        if "cross_attn" in cfg.block_pattern:
            set_gates(params, FRONTEND_GATE)
        tokens, aux = frontend_inputs(torch, cfg, (4, 40), gen)
        cpu = greedy(torch, params, cfg, tokens, aux, 8)
        gpu = greedy(torch, cuda(params), cfg, tokens.cuda(), aux.cuda(), 8)
        check(torch.equal(cpu["generated"], gpu["generated"].cpu()),
              f"{arch} reduced: served tokens differ: GPU {gpu['generated'].tolist()} CPU "
              f"{cpu['generated'].tolist()}")
        torch.testing.assert_close(gpu["logits"].cpu(), cpu["logits"], rtol=1e-4, atol=1e-4)
        serve_diff = float((gpu["logits"].cpu() - cpu["logits"]).abs().max())
        c, weights = 3, torch.tensor([1.7, 0.0, 2.4])
        toks, auxs = frontend_inputs(torch, cfg, (c, 2, 2, 17), gen)
        comps = [None, "int8"] if cfg.round_mode == "client_parallel" else [None]
        worst = {}
        for comp in comps:
            rs = fed_round.RoundSpec(cohort=c, local_steps=2, local_lr=0.05, local_batch=2,
                                     compression=None if comp is None else api.CompressionSpec(
                                         delta_dtype=comp, error_feedback=True))
            step = fed_round.build_round_step(cfg, rs)
            kw = {}
            if comp is not None:
                kw["resid"] = torch.zeros(transformer.param_count(params))
            args = (toks[..., :-1], toks[..., 1:], weights, auxs)
            want = step(params, *args, **kw)
            got = step(cuda(params), *cuda(args), **cuda(kw))
            check(abs(float(got[2]) - float(want[2])) <= 1e-5 * abs(float(want[2])),
                  f"{arch} reduced round ({comp}): loss {float(got[2])} against {float(want[2])}")
            rel = 0.0
            for g, w, p in zip(tree_leaves(got[0]), tree_leaves(want[0]), tree_leaves(params)):
                g, w, p = g.cpu().numpy(), w.numpy(), p.numpy()
                scale = max(float(np.abs(w).max()), 1e-30)
                slack = float(np.abs(w - p).max()) / 127 if comp else 0.0
                err = float(np.abs(g - w).max())
                check(err <= 1e-4 * scale + slack,
                      f"{arch} reduced round ({comp}): parameters off the CPU's by {err:.3g}")
                rel = max(rel, err / scale)
            worst[comp or "plain"] = rel
        print(f"frontend agreement {arch} reduced f32: served GPU == CPU greedy tokens "
              f"{tuple(gpu['generated'].shape)}, last logits max_abs_diff={serve_diff:.3g}; round "
              f"step ({cfg.round_mode}, C=3, R=2) parameters within "
              f"{ {k: f'{v:.3g}' for k, v in worst.items()} } of each leaf's scale "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("whisper-small"), n_layers=1, encoder_layers=1,
                              param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    params = transformer.init_params(cfg, gen, "cpu")
    tokens, aux = frontend_inputs(torch, cfg, (2, 16), gen)
    want = transformer.prefill(params, cfg, tokens, aux, max_seq=24, page_size=FRONTEND_PAGE)[0]
    before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    got = transformer.prefill(cuda(params), cfg, tokens.cuda(), aux.cuda(), max_seq=24,
                              page_size=FRONTEND_PAGE)[0]
    n7 = fa.flash_attention.launches - before
    check(n7 == forward_calls(cfg)["flash_attention"] == 3
          and fa.flash_attention.launches_tc == before_tc,
          f"whisper one layer: {n7} kernel-7 launches ({fa.flash_attention.launches_tc - before_tc} "
          "on the tensor cores), expected 3 on the CUDA cores")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    print(f"frontend agreement whisper-small full width, 1 encoder + 1 decoder layer, 1500 "
          f"frames, f32: prefill logits GPU vs CPU max_abs_diff="
          f"{float((got.cpu() - want).abs().max()):.3g} (kernel 7 on the CUDA cores, "
          f"bidirectional and cross at S_k=1500; {time.perf_counter() - t0:.1f} s)", flush=True)


def zoo_frontends_phase(torch, card: str) -> dict:
    """The vlm and audio families on the card: serving (ac) whisper-small
    and (ad) llama-3.2-vision-11b whole through ``transformer.prefill`` and
    greedy ``decode_step``s, rounds (ae) whisper-small whole
    (client_parallel, C = 8) and (af) the vlm one pattern deep at full
    width (cohort_sequential, C = 4) through ``build_round_step`` with
    ``aux_embeds``, each with exact launches of kernels 6 and 7; then the
    card against the CPU (``frontend_agreement``).  Returns the launches."""
    phase("zoo_frontends")
    import numpy as np

    from repro_torch import kernels

    t_phase = time.perf_counter()
    launches = {k: 0 for k in kernels.launch_counts()}
    laps = {}
    for i, (label, (arch, prompt_len, gate)) in enumerate(FRONTEND_SERVE.items()):
        t0 = time.perf_counter()
        for k, v in frontend_serve(torch, kernels, label, arch, prompt_len, gate, 41 + i,
                                   card).items():
            launches[k] += v
        laps[label.split()[0]] = round(time.perf_counter() - t0, 1)
    for label, (arch, layers, k_budget, c) in FRONTEND_ROUNDS.items():
        t0 = time.perf_counter()
        for k, v in frontend_round(torch, kernels, label, arch, layers, k_budget, c,
                                   card).items():
            launches[k] += v
        laps[label.split()[0]] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    frontend_agreement(torch, np)
    laps["agreement"] = round(time.perf_counter() - t0, 1)
    print(f"zoo_frontends phase: {time.perf_counter() - t_phase:.1f} s (seconds a step: "
          f"{json.dumps(laps)})", flush=True)
    return launches


# -- the memory switches -----------------------------------------------------------

# remat "full" against "none", bitwise: the CPU tests' reduced configs, f32.
REMAT_BITWISE = {
    "smollm-360m": dict(n_layers=2, d_model=64, d_ff=128, vocab=128),
    "zamba2-1.2b": dict(block_pattern=("mamba2", "mamba2", "mamba2", "shared_attn"),
                        n_layers=8, d_model=64, vocab=128),
    "qwen3-moe-235b-a22b": dict(n_layers=2, d_model=64, vocab=128),
    "xlstm-125m": dict(d_model=64, vocab=128),
}
# Peak memory and seconds a round both ways: label -> (zoo-phase label, the
# spec's sequence length).  (o) and (z) run with ``--only remat=...``.
REMAT_CELLS = {
    "n": ("(n) smollm-360m", ZOO_SEQ),
    "aa": ("(aa) xlstm-125m", ZOO_SEQ),
    "n1024": ("(n) smollm-360m", 1024),
    "o": ("(o) zamba2-1.2b", ZOO_SEQ),
    "z": ("(z) qwen3-moe one layer", ZOO_SEQ),
}
REMAT_DEFAULT = ("n", "aa", "n1024")
SLSTM_SEGMENT = 16  # divides the rounds' 64 tokens


def remat_bitwise(torch, kernels) -> None:
    """``vmap(grad_and_value(loss_fn))`` over two slots with ``remat``
    "full" and "none", on the card and on the CPU: bitwise-equal losses and
    gradients; on the card "full" launches ``train_calls`` (each decoder
    group's kernels once more) and "none" ``forward_calls``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fed.tasks import tree_leaves, tree_map
    from repro_torch.models import transformer

    for arch, kw in REMAT_BITWISE.items():
        cfg = get_config(arch).reduced(**kw)
        gen = torch.Generator().manual_seed(1)
        params = transformer.init_params(cfg, gen, "cpu")
        tok = torch.randint(0, cfg.vocab, (2, 2, 16), generator=gen)
        tgt = torch.randint(0, cfg.vocab, (2, 2, 16), generator=gen)
        line = []
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda x: x.to(dev), params)
            got = {}
            for mode in ("full", "none"):
                c = dataclasses.replace(cfg, remat=mode)
                fn = torch.func.vmap(torch.func.grad_and_value(
                    lambda q, t, y, c=c: transformer.loss_fn(q, c, (t, y))), in_dims=(None, 0, 0))
                kernels.reset_launch_counts()
                g, loss = fn(p, tok.to(dev), tgt.to(dev))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts = {k: v for k, v in kernels.launch_counts().items()
                              if k in ("rmsnorm", "flash_attention", "ssd_scan")}
                    want = (train_calls if mode == "full" else forward_calls)(c)
                    check(counts == want, f"remat {arch} {mode}: launches {counts}, want {want}")
                got[mode] = (loss.cpu(), [x.cpu() for x in tree_leaves(g)])
            (la, ga), (lb, gb) = got["full"], got["none"]
            diff = max(float((a - b).abs().max()) for a, b in zip(ga, gb))
            check(torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(ga, gb)),
                  f"remat {arch} on {dev}: full and none differ (losses {la} / {lb}, largest "
                  f"gradient difference {diff:.3g})")
            line.append(f"{dev} bitwise ({len(ga)} leaves)")
        print(f"remat {arch} reduced f32, vmap(grad) over 2 slots: full == none, "
              f"{', '.join(line)}; launches full {train_calls(cfg)} none {forward_calls(cfg)}",
              flush=True)


def slstm_segment_round(torch, card: str) -> None:
    """One xlstm-125m round step at full width in f32 (client_parallel,
    C = 4, one local step, seq 64, lr 2e-4) with ``slstm_segment`` 16
    against 0 from the same weights and tokens: the recompute runs under
    ``vmap(grad)``; the forward is the same, so the losses are bitwise
    equal, and the gradient of the sLSTM's ``r`` sums its steps a segment
    at a time, so the parameters and norms agree within f32 rounding (1e-5
    of each leaf's scale).  In bf16, or over two local steps, the rounding
    of the first step's update moves the second step's forward, and the
    sLSTM at full width amplifies that (``PERF.md`` §6)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fed import round as fed_round
    from repro_torch.fed.tasks import tree_leaves
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("xlstm-125m"), param_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(41)
    params = transformer.init_params(cfg, gen)
    c = 4
    tokens = torch.randint(0, cfg.vocab, (c, 1, ZOO_BATCH, ZOO_SEQ + 1), generator=gen, device=dev)
    weights = torch.tensor([0.4, 0.0, 0.3, 0.3], device=dev)
    spec = fed_round.RoundSpec(cohort=c, local_steps=1, local_lr=2e-4, local_batch=ZOO_BATCH)
    out, info = {}, {}
    for seg in (0, SLSTM_SEGMENT):
        step = fed_round.build_round_step(dataclasses.replace(cfg, slstm_segment=seg), spec)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[seg] = step(params, tokens[..., :-1], tokens[..., 1:], weights)
        torch.cuda.synchronize()
        info[seg] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9)
    (pa, na, la), (pb, nb, lb) = out[0], out[SLSTM_SEGMENT]
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(tree_leaves(pa), tree_leaves(pb)))
    norm_rel = float(((na - nb).abs() / nb.abs().clamp(min=1e-30)).max())
    check(math.isfinite(float(la)) and float(la) == float(lb) and rel <= 1e-5 and norm_rel <= 1e-5,
          f"slstm_segment {SLSTM_SEGMENT} against 0: losses {float(lb)} / {float(la)}, parameters "
          f"{rel:.3g} of a leaf's scale, norms {norm_rel:.3g} relative")
    print(f"xlstm-125m round step ({card}), f32, C={c} R=1 B={ZOO_BATCH} S={ZOO_SEQ}, "
          f"slstm_segment {SLSTM_SEGMENT} against 0 under vmap(grad): losses equal "
          f"({float(lb):.6f}), parameters within {rel:.3g} of each leaf's scale, norms within "
          f"{norm_rel:.3g}; seconds {info[SLSTM_SEGMENT][0]:.3f} vs {info[0][0]:.3f} (first use "
          f"of each shape), peak_mem_gb {info[SLSTM_SEGMENT][1]:.2f} vs {info[0][1]:.2f}",
          flush=True)


def remat_cell(torch, api, key: str, card: str) -> dict:
    """One zoo cell's round with ``remat`` "full" and "none": after a
    warm-up round, one round's wall seconds (host clock after a
    synchronize) and the peak memory allocated in it (parameters, carry
    and the round's own), each with a fresh run of the spec."""
    import dataclasses

    from repro_torch.api import runner

    label, seq = REMAT_CELLS[key]
    runs = {**ZOO_RUNS, **{k: v[:6] for k, v in FAMILY_RUNS.items()}}
    arch, kw, _, n, k, c = runs[label]
    sections = FAMILY_RUNS[label][6] if label in FAMILY_RUNS else {}
    spec = zoo_spec(api, arch, kwargs=kw, rounds=2, clients=n, budget=k, cohort=c, seq=seq,
                    **sections)
    built = api.build(spec)
    out = {}
    for mode in ("full", "none"):
        b = dataclasses.replace(built, arch_config=dataclasses.replace(built.arch_config, remat=mode))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        segment, state = runner._zoo_segment_and_state(b)
        state = segment(state, 1)  # warm-up: the first use of each shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        state = segment(state, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = float(state.metrics["loss"][1])
        check(math.isfinite(loss), f"remat {label} seq {seq} {mode}: loss {loss}")
        out[mode] = {"peak_gb": round(peak, 2), "round_s": round(wall, 4),
                     "held_gb": round(before, 2), "loss": loss}
        del state, segment
    torch.cuda.empty_cache()
    print(f"remat {label} seq {seq} ({card}), C={c} R={spec.federation.local_steps} "
          f"B={ZOO_BATCH}, one round after "
          f"a warm-up: full peak_mem_gb={out['full']['peak_gb']:.2f} round_s="
          f"{out['full']['round_s']:.4f}; none peak_mem_gb={out['none']['peak_gb']:.2f} round_s="
          f"{out['none']['round_s']:.4f} (held between rounds {out['full']['held_gb']:.2f} GB; "
          f"losses {out['full']['loss']:.6f} / {out['none']['loss']:.6f})", flush=True)
    return out


def remat_phase(torch, card: str, cells=REMAT_DEFAULT) -> None:
    """The memory switches on the card: ``remat`` full against none
    bitwise on the reduced dense, hybrid, moe and xlstm configs (with the
    recompute's exact launches); an xlstm-125m round with ``slstm_segment``
    16 against 0; then peak memory and seconds a round both ways of the
    ``cells`` (default (n), (aa) and (n) at seq 1024)."""
    phase("remat")
    from repro_torch import api, kernels

    t0 = time.perf_counter()
    remat_bitwise(torch, kernels)
    slstm_segment_round(torch, card)
    for key in cells:
        remat_cell(torch, api, key, card)
    kernels.reset_launch_counts()  # measurements, not the path
    print(f"remat phase: {time.perf_counter() - t0:.1f} s", flush=True)


def lint_phase(torch) -> None:
    """The trace lint: ``python -m repro_torch.analysis.lint --fast`` over
    the whole registry (every sampler x oracle/deployable x compiled/
    reference, sharded, faulted, compressed, and the serve cell; on the
    CPU over fake tensors) exits 0; then ``launch.train --lint`` on the
    card lints a reduced smollm zoo spec, trains it, and exits 1 when a
    float64 leak is planted in the round body."""
    phase("lint")
    from repro_torch.fed import round as fed_round
    from repro_torch.launch import train

    rc, _, err, sweep_s = cpu_job("lint")
    check(rc == 0, f"the lint sweep found a violation (exit {rc}): {err[-2000:]}")
    flags = ["--arch", "smollm-360m", "--reduced", "--compiled", "--rounds", "2", "--clients",
             "13", "--budget", "2", "--cohort", "3", "--seq", "16", "--local-batch", "2", "--lint"]
    t1 = time.perf_counter()
    out = train.main(flags)
    check(len(out["losses"]) == 2 and all(math.isfinite(float(x)) for x in out["losses"]),
          f"launch.train --lint: losses {out['losses']}")
    lint_train_s = time.perf_counter() - t1
    mean_loss = fed_round._cohort_mean_loss
    fed_round._cohort_mean_loss = lambda losses, w: mean_loss(losses, w).double().float()
    try:
        train.main(flags)
        check(False, "launch.train --lint trained past a planted float64 leak")
    except SystemExit as e:
        check(e.code == 1, f"launch.train --lint exit code {e.code} on a planted leak")
    finally:
        fed_round._cohort_mean_loss = mean_loss
    print(f"lint: registry sweep --fast clean in {sweep_s:.1f} s (a CPU process beside the card's "
          f"phases, two threads); launch.train --lint on the card "
          f"(lint, then 2 rounds) {lint_train_s:.1f} s, exit 1 on a planted float64 leak",
          flush=True)


# -- the dry run ------------------------------------------------------------------

# Steps predicted by ``launch.dryrun``'s setups (``analysis.cost.count`` on
# ``meta`` tensors) and then run on the card, bf16 at full width, weights from
# seed 0: label -> (arch, (kind, seq_len, global batch), clients of a round).
DRYRUN_STEPS = {
    "(ag) smollm-360m prefill": ("smollm-360m", ("prefill", 512, 8), None),  # (k)'s prompt
    "(ah) smollm-360m round": ("smollm-360m", ("train", ZOO_SEQ, 8 * ZOO_STEPS * ZOO_BATCH), 8),
    "(ai) zamba2-1.2b prefill": ("zamba2-1.2b", ("prefill", 512, 8), None),  # (m)'s prompt
    "(aj) smollm-360m decode": ("smollm-360m", ("decode", 512 + 64, 8), None),  # (k)'s caches
}
PEAK_BAND = (0.10, 256e6)  # a predicted peak within 10% or 256 MB of the card's


def dryrun_args(torch, cfg, kind: str, batch: int, seq: int, cohort, gen):
    """Real arguments on the card for a ``launch.dryrun`` setup: weights
    from ``gen``, int32 tokens uniform over the vocabulary, a round's
    cohort weights from a K-Vib draw (N = 32, K = 6), zeroed caches."""
    from repro_torch.core.samplers import make_sampler
    from repro_torch.launch.dryrun import LOCAL_STEPS
    from repro_torch.models import transformer
    from repro_torch.rng import PhiloxSource

    dev = torch.device("cuda")
    params = transformer.init_params(cfg, gen, dev)

    def tokens(*shape):
        return torch.randint(0, cfg.vocab, shape, dtype=torch.int32, device=dev, generator=gen)

    if kind == "prefill":
        return [params, tokens(batch, seq)]
    if kind == "decode":
        return [params, tokens(batch, 1), transformer.init_caches(cfg, batch, seq, device=dev)]
    shape = (cohort, LOCAL_STEPS, batch // (cohort * LOCAL_STEPS), seq)
    sampler = make_sampler("kvib", n=32, budget=6, horizon=2)
    sel, _, _ = kvib_cohort(torch, sampler, sampler.init(dev), PhiloxSource(0, dev), 0, 32, cohort)
    return [params, tokens(*shape), tokens(*shape), sel.weights]


def cublas_workspace(torch) -> int:
    """The bytes of one cuBLAS workspace: what a thread's first matmul on a
    stream allocates for good (its handle's workspace), measured after
    every workspace is freed."""
    check(hasattr(torch._C, "_cuda_clearCublasWorkspaces"),
          "this torch cannot free cuBLAS's workspaces (torch._C._cuda_clearCublasWorkspaces)")
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    before = torch.cuda.memory_allocated()
    a = torch.ones(64, 64, dtype=torch.bfloat16, device="cuda")
    out = a @ a
    torch.cuda.synchronize()
    del a, out
    return torch.cuda.memory_allocated() - before


def dryrun_step(torch, kernels, label: str, card: str, workspace: int) -> None:
    """One step predicted, then run on the card: its peak (the card's
    ``max_memory_allocated`` over a call after a warm-up, less what was
    allocated before its arguments were made) against the count's
    arguments + temporaries + the cuBLAS workspaces the step makes,
    ``workspace`` bytes for each thread that runs its matmuls (the caller's,
    and in a round the autograd engine's device thread, which runs the
    backward); its time (median of 5 after a warm-up) against
    ``max(compute_s, memory_s)`` at ``HW``; and kernels 6-8's launches
    against the count's calls, exactly.  Every workspace is freed before
    the step, and what the warm-up leaves allocated for good must be those
    workspaces, exactly."""
    from repro_torch.analysis.cost import count
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun

    arch, (kind, seq, batch), cohort = DRYRUN_STEPS[label]
    cfg = get_config(arch)
    fn, meta_args, tokens_processed = dryrun.setup(cfg, InputShape(label, seq, batch, kind), cohort)
    t0 = time.perf_counter()
    cost, _ = count(fn, *meta_args)
    trace_s = time.perf_counter() - t0
    threads = 2 if kind == "train" else 1
    predicted = cost.argument_size_bytes + cost.temp_size_bytes + threads * workspace
    roof = max(cost.flops / HW.peak_flops, cost.bytes_accessed / HW.hbm_bw)
    bound_by = "compute" if cost.flops / HW.peak_flops >= cost.bytes_accessed / HW.hbm_bw else "memory"

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = dryrun_args(torch, cfg, kind, batch, seq, cohort,
                       torch.Generator(device="cuda").manual_seed(0))
    check([(t.shape, t.dtype) for t in _leaves(args)]
          == [(t.shape, t.dtype) for t in _leaves(meta_args)],
          f"{label}: the card's arguments differ from the setup's in shape or dtype")
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in _leaves(args)}
    arg_bytes = sum(storages.values())
    if kind == "decode":  # parameters and caches: the count's arguments exactly
        check(arg_bytes == cost.argument_size_bytes,
              f"{label}: arguments {arg_bytes} B on the card, {cost.argument_size_bytes} counted")
    held = torch.cuda.memory_allocated()
    out = fn(*args)  # warm-up: the first use of each shape
    torch.cuda.synchronize()
    del out
    left = torch.cuda.memory_allocated() - held
    check(left == threads * workspace,
          f"{label}: the warm-up left {left} B allocated, {threads} cuBLAS workspace(s) are "
          f"{threads * workspace} B")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    del out
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        del out
    step_s = sorted(times)[2]
    calls = {k: v["calls"] for k, v in cost.kernels.items()}
    check(launches == calls, f"{label}: kernel launches {launches}, counted {calls}")
    band = max(PEAK_BAND[0] * peak, PEAK_BAND[1])
    print(f"{label} ({card}): {kind}, {cfg.name} bf16 full width{f', C={cohort}' if cohort else ''}"
          f", B={batch} S={seq}: peak predicted {predicted / 1e9:.3f} GB (arguments "
          f"{cost.argument_size_bytes / 1e9:.3f} + temporaries {cost.temp_size_bytes / 1e9:.3f} "
          f"+ {threads} cuBLAS workspace(s) {threads * workspace / 1e6:.1f} MB) against the card's "
          f"{peak / 1e9:.3f} GB ({predicted / peak - 1:+.2%}; arguments on the card "
          f"{arg_bytes / 1e9:.3f}); step "
          f"{step_s * 1e3:.3f} ms (median of 5 after a warm-up) "
          f"against the roofline's {roof * 1e3:.3f} ms ({bound_by}: {cost.flops:.4g} FLOP, "
          f"{cost.bytes_accessed:.4g} B eager) = {roof / step_s:.2%} of the roofline; kernel "
          f"launches {launches} as counted; count {trace_s:.1f} s", flush=True)
    check(abs(predicted - peak) <= band,
          f"{label}: predicted peak {predicted / 1e9:.3f} GB, the card's {peak / 1e9:.3f} GB "
          f"(band {band / 1e9:.3f} GB)")
    del args
    torch.cuda.empty_cache()


def dryrun_phase(torch, card: str) -> None:
    """The dry run against the card: each of ``DRYRUN_STEPS`` predicted and
    run (``dryrun_step``); then ``python -m repro_torch.launch.dryrun`` at
    full width for ``DRYRUN_CLI`` as subprocesses (on the CPU, CUDA never
    initialised) and ``python -m repro_torch.analysis.report`` over their
    records, printed."""
    phase("dryrun")
    from repro_torch import kernels

    t0 = time.perf_counter()
    workspace = cublas_workspace(torch)
    print(f"dryrun: one cuBLAS workspace {workspace} B ({workspace / 2**20:.2f} MiB)", flush=True)
    for label in DRYRUN_STEPS:
        dryrun_step(torch, kernels, label, card, workspace)
    kernels.reset_launch_counts()  # measurements, not the path
    out_dir = ROOT / "results" / "torch" / "smoke" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.json"):
        old.unlink()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for arch, shape in DRYRUN_CLI:
        rc, stdout, err, cli_s = cpu_job(f"dryrun {arch} {shape}")
        check(rc == 0, f"launch.dryrun {arch} {shape}: {err[-2000:]}")
        print(f"launch.dryrun {arch} {shape}: {cli_s:.1f} s, a CPU process beside the card's "
              "phases", flush=True)
        record = json.loads(stdout.strip().splitlines()[-1])
        check(record["status"] == "ok" and record["flops"] > 0 and record["bytes_accessed"] > 0,
              f"launch.dryrun {arch} {shape}: {record.get('status')}")
        (out_dir / f"{arch}__{shape}__sp.json").write_text(json.dumps(record, indent=1))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report", "--dir",
                           str(out_dir)], capture_output=True, text=True, timeout=120, env=env,
                          cwd=str(ROOT))
    check(proc.returncode == 0 and "| 1xH100 | ok |" in proc.stdout,
          f"analysis.report: {proc.stderr[-2000:]}")
    print(proc.stdout, flush=True)
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s", flush=True)


# -- the train-to-serve loop ---------------------------------------------------

# (s), (t): ``launch.train`` and ``launch.serve --follow`` as two processes,
# bf16 at the configs' widths and depths.  (s) is the reference launcher's
# defaults but for the rounds and the checkpoints; (t) cuts zamba2's cohort
# to C = 4 so that the trainer (62.87 GB at C = 8 in the zoo phase) and the
# server fit the card together.
SERVE_LOOP_RUNS = {  # label: (zoo-phase label of the same model, trainer flags)
    "(s) smollm-360m": ("(n) smollm-360m", [
        "--arch", "smollm-360m", "--compiled", "--rounds", "2", "--clients", "32",
        "--budget", "6", "--cohort", "8", "--seq", "64", "--local-batch", "2",
        "--ckpt-every", "2"]),
    "(t) zamba2-1.2b": ("(o) zamba2-1.2b", [
        "--arch", "zamba2-1.2b", "--compiled", "--rounds", "2", "--clients", "32",
        "--budget", "3", "--cohort", "4", "--seq", "64", "--local-batch", "2",
        "--ckpt-every", "2"]),
}
# The trainer-alone comparison runs for (s) only: (t)'s alone run was cut to
# make room for the model_axis phase (its seconds a round alone are the zoo
# phase's (o)).
SERVE_LOOP_ALONE = ("(s) smollm-360m",)
SERVE_SUMMARY = re.compile(
    r"^serve summary: promotions=(\d+) rollbacks=(\d+) tokens=(\d+) "
    r"tokens_per_sec=([\d.]+) swaps=(\d+) last_step=(\d+) batches=(\d+)$", re.M)


def _flag(flags: list, name: str) -> str:
    return flags[flags.index(name) + 1]


def _summary(label: str, text: str, rounds: int, boundaries: int) -> dict:
    """The session's summary line, parsed and checked: ``last_step`` at the
    horizon, ``swaps == promotions``, 1 to ``boundaries`` decisions."""
    found = SERVE_SUMMARY.findall(text)
    check(len(found) == 1, f"{label}: {len(found)} summary lines")
    keys = ("promotions", "rollbacks", "tokens", "tokens_per_sec", "swaps", "last_step", "batches")
    got = {k: (float(v) if k == "tokens_per_sec" else int(v)) for k, v in zip(keys, found[0])}
    check(got["last_step"] == rounds, f"{label}: last_step {got['last_step']}, horizon {rounds}")
    check(got["swaps"] == got["promotions"], f"{label}: {got['swaps']} swaps, "
          f"{got['promotions']} promotions")
    check(1 <= got["promotions"] + got["rollbacks"] <= boundaries,
          f"{label}: {got['promotions'] + got['rollbacks']} decisions for {boundaries} boundaries")
    return got


def _static_decode_tps(torch, arch: str, chunks: int = 3) -> float:
    """Decode tokens/s with no trainer on the card: the followed run's
    serving geometry (``ServeSpec`` defaults: 2 x (16 + 48), chunks of 16
    steps), random weights."""
    from repro_torch.api import ServeSpec
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    srv, cfg = ServeSpec(), get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    engine = ServeEngine(cfg, transformer.init_params(cfg, gen, "cuda"), batch=srv.batch,
                         max_seq=srv.max_seq, page_size=srv.page_size)
    prompts = torch.randint(0, cfg.vocab, (srv.batch, srv.prompt_len), device="cuda")
    engine.start(prompts)
    engine.step(srv.decode_steps_per_poll)  # warm-up
    engine.decode_tokens, engine.decode_seconds = 0, 0.0
    for _ in range(chunks):
        if engine.capacity <= 0:
            engine.start(prompts)
        engine.step(min(srv.decode_steps_per_poll, engine.capacity))
    return engine.tokens_per_sec()


def train_and_follow(torch, label: str, flags: list, root: Path, card: str,
                     alone_run: bool = True) -> dict:
    """One cross-process run: the trainer alone (``python -m
    repro_torch.launch.train ... --ckpt DIR/alone``), then the trainer
    (``--ckpt DIR/fl``) and the follower
    (``python -m repro_torch.launch.serve --follow DIR/fl_ckpts --timeout
    600``) started together, both on the card.  Checks both exit 0, the
    summary line, and the gate's kernel launches: exactly kernels 6-8's
    calls in one forward x the batches scored (``eval_batches`` x (1 +
    decisions)).  Returns the gate's launches."""
    from repro_torch.api import ServeSpec
    from repro_torch.configs import get_config

    root.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    # The same trainer command with no follower first: what the follower
    # costs the trainer, both with their first round's warm-up and writes.
    alone_s = "not run"
    if alone_run:
        alone = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *flags, "--ckpt",
             str(root / "alone")], capture_output=True, text=True, env=env, cwd=str(root),
            timeout=600)
        check(alone.returncode == 0, f"{label}: the trainer alone exited {alone.returncode}:\n"
              f"{(alone.stdout + alone.stderr)[-3000:]}")
        alone_s = float(re.search(r"\(([\d.]+)s/round\)", alone.stdout).group(1))
    cmds = {
        "trainer": [sys.executable, "-m", "repro_torch.launch.train", *flags,
                    "--ckpt", str(root / "fl")],
        "server": [sys.executable, "-m", "repro_torch.launch.serve", "--follow",
                   str(root / "fl_ckpts"), "--timeout", "600"],
    }
    procs, logs = {}, {}
    t0 = time.perf_counter()
    try:
        for name, cmd in cmds.items():
            logs[name] = root / f"{name}.log"
            with open(logs[name], "w") as f:
                procs[name] = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                                               cwd=str(root))
        rcs = {name: p.wait(timeout=660) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    out = {name: path.read_text() for name, path in logs.items()}
    for name, rc in rcs.items():
        check(rc == 0, f"{label}: the {name} exited {rc}:\n{out[name][-3000:]}")
    rounds, every = int(_flag(flags, "--rounds")), int(_flag(flags, "--ckpt-every"))
    summary = _summary(label, out["server"], rounds, rounds // every)
    stats = json.loads(out["server"].split("follow stats ", 1)[1].splitlines()[0])
    decisions = summary["promotions"] + summary["rollbacks"]
    cfg = get_config(_flag(flags, "--arch"))
    scored = ServeSpec().eval_batches * (1 + decisions)
    want = {k: v * scored for k, v in forward_calls(cfg).items() if v}
    check(stats["gate_launches"] == want,
          f"{label}: gate launches {stats['gate_launches']}, expected {want}")
    per_round = float(re.search(r"\(([\d.]+)s/round\)", out["trainer"]).group(1))
    print(f"{label} ({card}): trainer + follower as two processes, {wall:.1f} s; "
          f"{out['server'].count('boundary step')} boundaries seen, {summary}; gate launches "
          f"{stats['gate_launches']} (every parameter tensor of the engine at its address after "
          f"{summary['swaps']} swaps)", flush=True)
    print(f"{label} ({card}): restore s a boundary {[round(x, 4) for x in stats['restore_s']]}; "
          f"gate s a decision (first: the prime) {[round(x, 4) for x in stats['gate_s']]}; decode "
          f"tokens/s with the trainer running {summary['tokens_per_sec']}; trainer s a round "
          f"(checkpoint writes and the first round's warm-up included) with a follower "
          f"{per_round}, the same command alone {alone_s}", flush=True)
    return {"gate": stats["gate_launches"], "per_round": per_round}


def boundary_cost(torch, api, card: str, root: Path) -> None:
    """What one boundary costs the loop, in this process: (s)'s spec's
    round-0 ``TrainState`` (smollm-360m, bf16) published by
    ``CheckpointManager.save`` and read back by ``restore``, each timed
    alone (the trainer's and the watcher's side of a commit)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    args = train.make_parser().parse_args(SERVE_LOOP_RUNS["(s) smollm-360m"][1])
    spec = train.build_spec_from_args(args)
    template = api.restore_template(spec)
    manager = CheckpointManager(str(root / "boundary"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = manager.save(template, step=1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    manager.restore(template, 1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    gb = Path(path).stat().st_size / 1e9
    print(f"(s) boundary cost ({card}): save {save_s:.3f} s, restore {restore_s:.3f} s of a "
          f"{gb:.3f} GB checkpoint ({gb / save_s:.3f} and {gb / restore_s:.3f} GB/s)", flush=True)


def swap_vs_static(torch, card: str, reps: int = 2) -> None:
    """(v) (k)'s engine (smollm-360m, bf16, full width and depth, 8 x (512 +
    64)) decoding 63 steps in chunks of 16 with no swap, and with an
    alternate parameter set copied in after every chunk (the reference's
    ``bench_fed_serve_swap``), in turns static, swap, swap, static, ...:
    tokens/s of each (median) and their ratio.  Not gated: host-bound
    decode spreads 20% between runs."""
    from repro_torch.configs import get_config
    from repro_torch.fed.tasks import tree_leaves
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = get_config("smollm-360m")
    gens = [torch.Generator(device="cuda").manual_seed(k) for k in (11, 12)]
    params, variant = (transformer.init_params(cfg, g, "cuda") for g in gens)
    engine = ServeEngine(cfg, params, batch=8, max_seq=576, page_size=16)
    prompts = torch.randint(0, cfg.vocab, (8, 512), device="cuda")
    ptrs = [p.data_ptr() for p in tree_leaves(engine.params)]
    tps = {"static": [], "swap": []}

    def run(swapping: bool) -> float:
        if swapping:
            engine.swap_params(params)
        engine.start(prompts)
        engine.decode_tokens, engine.decode_seconds = 0, 0.0
        done = 0
        while engine.capacity > 0:
            done += engine.step(16)
            if swapping:
                engine.swap_params(variant if done % 32 else params)
        return engine.tokens_per_sec()

    run(False)  # warm-up
    for k in range(reps):
        for way in (("static", "swap") if k % 2 == 0 else ("swap", "static")):
            tps[way].append(run(way == "swap"))
    check(ptrs == [p.data_ptr() for p in tree_leaves(engine.params)],
          "(v): engine parameters moved under swaps")
    med = {way: sorted(v)[len(v) // 2] for way, v in tps.items()}
    print(f"(v) swap-heavy against static decode ({card}): smollm-360m bf16, 8 x (512 + 64), "
          f"a swap every 16 steps: static {med['static']:.1f} tokens/s, swap "
          f"{med['swap']:.1f} tokens/s, ratio {med['swap'] / med['static']:.3f} (medians of "
          f"{reps}: {json.dumps({k: [round(x, 1) for x in v] for k, v in tps.items()})}; "
          f"{engine.swaps} swaps; not gated)", flush=True)


def launcher_resume(root: Path) -> None:
    """``launch.train --compiled`` at the reduced arch on the card, killed
    after its first segment (``REPRO_KILL_AFTER_SEGMENTS=1``), then
    ``--resume``: final parameters bitwise those of an uninterrupted run."""
    import numpy as np

    flags = ["--arch", "smollm-360m", "--reduced", "--compiled", "--rounds", "4",
             "--clients", "8", "--budget", "2", "--cohort", "3", "--seq", "16",
             "--ckpt-every", "2"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *flags]

    def run(ckpt: str, *extra, kill: bool = False):
        return subprocess.Popen([*cmd, "--ckpt", str(root / ckpt), *extra],
                                env={**env, "REPRO_KILL_AFTER_SEGMENTS": "1" if kill else "0"},
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                cwd=str(root))

    root.mkdir(parents=True, exist_ok=True)
    killed, full = run("k", kill=True), run("full")
    outs = {name: p.communicate(timeout=300)[0] for name, p in (("k", killed), ("full", full))}
    check(killed.returncode == -9, f"launcher resume: the killed run exited {killed.returncode}:"
          f"\n{outs['k'][-2000:]}")
    check(full.returncode == 0, f"launcher resume: the full run failed:\n{outs['full'][-2000:]}")
    resumed = run("k", "--resume")
    text = resumed.communicate(timeout=300)[0]
    check(resumed.returncode == 0 and "resumed from checkpoint step 2" in text,
          f"launcher resume: the resumed run:\n{text[-2000:]}")
    with np.load(root / "k.npz") as a, np.load(root / "full.npz") as b:
        check(sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files),
            "launcher resume: final parameters differ from the uninterrupted run")
        n = len(a.files)
    print(f"launcher resume: killed after segment 1 of 2 (SIGKILL), --resume: the final "
          f"checkpoint's {n} leaves bitwise the uninterrupted run's", flush=True)


def serve_loop_phase(torch, card: str) -> dict:
    """The train-to-serve loop on the card: (s) smollm-360m and (t)
    zamba2-1.2b, each a ``launch.train`` process and a ``launch.serve
    --follow`` process at full width and depth; decode tokens/s with no
    trainer at the same geometry; what one boundary's save and restore
    cost alone; (u) ``python -m
    repro_torch.examples.fed_lm --serve --rounds 6 --clients 8 --budget 3``
    in this process; (v) swap-heavy against static decode; the launcher's
    kill and resume.  Returns the gates' launches in (s) and (t)."""
    phase("serve_loop")
    import shutil
    import tempfile

    from repro_torch import api
    from repro_torch.examples import fed_lm

    torch.cuda.empty_cache()
    launches = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_loop_"))
    try:
        for label, (zoo_label, flags) in SERVE_LOOP_RUNS.items():
            got = train_and_follow(torch, label, flags, root / label[1], card,
                                   alone_run=label in SERVE_LOOP_ALONE)
            for k, v in got["gate"].items():
                launches[k] = launches.get(k, 0) + v
            arch = _flag(flags, "--arch")
            print(f"{label}: decode tokens/s with no trainer ({card}, same geometry, this "
                  f"process) {_static_decode_tps(torch, arch):.1f}; trainer s a round alone "
                  f"(zoo phase {zoo_label}, C = 8, no checkpoint) "
                  f"{ZOO_ROUND_S.get(zoo_label, float('nan')):.4f}", flush=True)
            shutil.rmtree(root / label[1], ignore_errors=True)
            torch.cuda.empty_cache()
        boundary_cost(torch, api, card, root)
        t0 = time.perf_counter()
        res = fed_lm.main(["--serve", "--rounds", "6", "--clients", "8", "--budget", "3"])
        wall = time.perf_counter() - t0
        summary = _summary("(u) fed_lm --serve", res["summary"].render(), 6, 3)
        check(res["engine"].device.type == "cuda", "(u): not served on the card")
        print(f"(u) fed_lm --serve ({card}): {wall:.1f} s, {summary}; restore s "
              f"{[round(x, 4) for x in res['watcher'].restore_seconds]}, gate s "
              f"{[round(x, 4) for x in res['gate'].score_seconds]}", flush=True)
        del res
        swap_vs_static(torch, card)
        launcher_resume(root / "resume")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _serve_checks(torch, label, engine, counts, want, new_tokens):
    cfg = engine.cfg
    check(engine.device.type == "cuda", f"{label}: engine on {engine.device}")
    want = {k: want.get(k, 0) for k in counts}
    check(counts == want, f"{label}: kernel launches {counts}, expected {want}")
    gen = engine.generated()
    check(tuple(gen.shape) == (engine.batch, new_tokens), f"{label}: generated {tuple(gen.shape)}")
    check(int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab, f"{label}: token ids out of range")
    logits = engine.last_logits
    check(tuple(logits.shape) == (engine.batch, 1, cfg.vocab), f"{label}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")


def _tensor_core_check(label, counts):
    """Every kernel-7 launch of a bf16 serving run took the tensor-core
    kernel."""
    from repro_torch.kernels import flash_attention as fa

    tc = fa.flash_attention.launches_tc
    check(tc == counts["flash_attention"],
          f"{label}: {tc} of {counts['flash_attention']} kernel-7 launches on the tensor cores")
    print(f"{label}: kernel 7 on the tensor cores in {tc} of {counts['flash_attention']} launches")


def prefill_ab(torch, engine, label: str) -> None:
    """One engine's 8 x 512 prefill with kernel 7 on the tensor cores, then
    with every launch sent to the CUDA-core kernel (the kernel before the
    tensor-core one: ``uses_tensor_cores`` is replaced by a function that
    says no, for this measurement only), then on the tensor cores again: the
    median wall time of 3 prefills outside the profiler, and the kernel time
    and kernel 7's share under it."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    prompts = torch.randint(0, engine.cfg.vocab, (engine.batch, 512), generator=gen, device="cuda")
    chooser = fa.uses_tensor_cores
    try:
        for path in ("tensor cores", "CUDA cores", "tensor cores"):
            fa.uses_tensor_cores = chooser if path == "tensor cores" else (lambda dtype, hd: False)
            engine.start(prompts)
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine.start(prompts)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof = profile_kernels(torch, lambda: engine.start(prompts),
                                   f"{label} prefill 8x512, kernel 7 on the {path}", "one prefill", top=3)
            k7 = sum(v[0] for key, v in prof.items() if "flash_fwd" in key)
            print(f"{label} prefill with kernel 7 on the {path}: wall_s={sorted(walls)[1]:.4f} "
                  f"(median of 3, outside the profiler) kernel_s={sum(v[0] for v in prof.values()) / 1e6:.4f} "
                  f"kernel7_ms={k7 / 1e3:.3f}", flush=True)
    finally:
        fa.uses_tensor_cores = chooser


def serve_path_phase(torch, kernels):
    """(k) ``repro_torch.launch.serve`` as a user runs it (no device flag:
    the GPU), smollm-360m at full width and depth in bf16: one prefill of
    8 x 512 tokens and 63 decode steps, so kernel 6 runs 65 x 64 times and
    kernel 7 32 times.  (l) gemma2-27b at full width (hd 128, vocab 256,000,
    window 4096, both softcaps, embedding scale, tanh-gelu) cut to one
    (attn_local, attn) pattern, through ``ServeEngine``: 8 x 512 prompt, 16
    new tokens.  (m) ``repro_torch.launch.serve`` again, zamba2-1.2b at full
    width and depth in bf16 (38 blocks: 36 mamba2, 2 invocations of the
    shared attention block; 1,053,612,800 parameters), the same batch,
    prompt and tokens as (k): kernel 8 once a mamba2 block in the one
    prefill (36), kernel 7 twice, kernel 6 77 times a pass (two a block,
    one final) x 64 passes.  Returns the launches and the engines of (k)
    and (m)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = serve.main(SERVE_K)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    engine = out["engine"]
    cfg = engine.cfg
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.param_dtype) == (32, 960, 49152, torch.bfloat16),
          f"(k): not smollm-360m at full width: {cfg}")
    per_pass = 2 * cfg.n_layers + 1
    new = int(SERVE_K[SERVE_K.index("--new-tokens") + 1])
    _serve_checks(torch, "(k)", engine, counts,
                  {"rmsnorm": per_pass * new, "flash_attention": cfg.n_layers}, new)
    _tensor_core_check("(k)", counts)
    check(out["prefill_launches"]["rmsnorm"] == per_pass
          and out["prefill_launches"]["flash_attention"] == cfg.n_layers,
          f"(k): prefill launches {out['prefill_launches']}")
    launches = dict(counts)
    print(f"(k) smollm-360m serve: {transformer.param_count(engine.params) / 1e6:.1f}M params bf16, "
          f"batch 8, prompt 512, {new} new tokens: prefill_s={out['prefill_s']:.4f} "
          f"decode_s={out['decode_s']:.4f} ({new - 1} steps) tokens_per_sec={out['tokens_per_sec']:.1f} "
          f"decode_ms_per_step={out['decode_s'] / (new - 1) * 1e3:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)

    cfg_l = dataclasses.replace(get_config("gemma2-27b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init_params(cfg_l, gen)
    n_params = transformer.param_count(params)
    eng_l = ServeEngine(cfg_l, params, batch=GEMMA_L["batch"],
                        max_seq=GEMMA_L["prompt_len"] + GEMMA_L["new_tokens"],
                        page_size=GEMMA_L["page_size"], seed=1)
    del params
    prompts = torch.randint(0, cfg_l.vocab, (GEMMA_L["batch"], GEMMA_L["prompt_len"]),
                            generator=gen, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng_l.start(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    eng_l.step(GEMMA_L["new_tokens"] - 1)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    _serve_checks(torch, "(l)", eng_l, counts,
                  {"rmsnorm": 5 * GEMMA_L["new_tokens"], "flash_attention": 2}, GEMMA_L["new_tokens"])
    _tensor_core_check("(l)", counts)
    for k, v in counts.items():
        launches[k] += v
    print(f"(l) gemma2-27b full width, 2 layers: {n_params / 1e9:.3f}B params bf16, batch 8, "
          f"prompt 512, {GEMMA_L['new_tokens']} new tokens: prefill_s={prefill_s:.4f} "
          f"decode_s={eng_l.decode_seconds:.4f} tokens_per_sec={eng_l.tokens_per_sec():.1f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)
    prefill_ab(torch, eng_l, "(l)")
    del eng_l
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = serve.main(SERVE_M)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    eng_m = out["engine"]
    cfg = eng_m.cfg
    n_params = transformer.param_count(eng_m.params)
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab, cfg.param_dtype, n_params)
          == ("hybrid", 38, 2048, 32000, torch.bfloat16, ZAMBA2_PARAMS),
          f"(m): not zamba2-1.2b at full width and depth: {cfg}, {n_params} parameters")
    reps = cfg.pattern_repeats()
    n_mamba = cfg.block_pattern.count("mamba2") * reps
    n_shared = cfg.block_pattern.count("shared_attn") * reps
    per_pass = 2 * cfg.n_layers + 1
    new = int(SERVE_M[SERVE_M.index("--new-tokens") + 1])
    _serve_checks(torch, "(m)", eng_m, counts,
                  {"rmsnorm": per_pass * new, "flash_attention": n_shared, "ssd_scan": n_mamba}, new)
    _tensor_core_check("(m)", counts)
    want_prefill = {"rmsnorm": per_pass, "flash_attention": n_shared, "ssd_scan": n_mamba}
    check({k: out["prefill_launches"][k] for k in want_prefill} == want_prefill,
          f"(m): prefill launches {out['prefill_launches']}")
    for k, v in counts.items():
        launches[k] += v
    print(f"(m) zamba2-1.2b serve: {n_params:,} params bf16 ({n_mamba} mamba2 + {n_shared} shared_attn "
          f"blocks), batch 8, prompt 512, {new} new tokens: prefill_s={out['prefill_s']:.4f} "
          f"decode_s={out['decode_s']:.4f} ({new - 1} steps) tokens_per_sec={out['tokens_per_sec']:.1f} "
          f"decode_ms_per_step={out['decode_s'] / (new - 1) * 1e3:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)
    return launches, {"k": engine, "m": eng_m}


def _close_leaves(torch, got, want, what: str, rel: float = 1e-4) -> float:
    """Each leaf of ``got`` (on the card) within ``rel`` of ``want`` (on the
    CPU), relative and scaled by the leaf's largest entry; returns the
    largest difference over that scale."""
    from repro_torch.fed.tasks import tree_leaves

    worst = 0.0
    got, want = tree_leaves(got), tree_leaves(want)
    check(len(got) == len(want), f"{what}: {len(got)} leaves against {len(want)}")
    for g, w in zip(got, want):
        g, w = (t.detach().float().cpu() for t in (g, w))
        scale = max(float(w.abs().max()), 1e-30)
        torch.testing.assert_close(g, w, rtol=rel, atol=rel * scale, msg=what)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def autograd_phase(torch):
    """Gradients through kernels 6-8 on the card: the kernel runs the
    forward (its launches counted), the wrapper's ``torch.autograd.Function``
    runs the PyTorch backward.  In f32, each wrapper's gradients equal the
    CPU's (plain forward, the same backward), and so do the gradients of
    ``loss_fn`` for a reduced smollm-360m and a reduced zamba2-1.2b on the
    same weights, within 1e-4 of each leaf's largest entry; then
    ``torch.func.vmap(torch.func.grad_and_value(loss_fn))`` over two
    clients' parameters equals a loop of ``grad_and_value`` (kernel 6 loops
    over the clients' norm weights, kernels 7 and 8 fold them into B); then
    bf16 gradients are finite, kernel 8's at a decay of -0.75 a step."""
    phase("autograd")
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.fed.tasks import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import transformer

    gen = torch.Generator().manual_seed(5)

    def cuda(tree):
        return tree_map(lambda t: t.to("cuda"), tree)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    def scan(*a):
        return ssd.ssd_scan(*a, chunk=32, return_state=True)

    cases = {  # name: (f32 inputs on the CPU, call); (m)'s head sizes, a few rows
        "rmsnorm": ((rand(8, 960), 0.1 * rand(960)), rms.rmsnorm),
        "flash_attention": (
            (rand(2, 15, 64, 64), rand(2, 5, 64, 64), rand(2, 5, 64, 64)),
            lambda q, k, v: fa.flash_attention(q, k, v, q_groups=3, window=48, softcap=30.0)),
        "ssd_scan": ((rand(1, 4, 96, 64), -0.1 * rand(1, 4, 96).abs(), rand(1, 96, 64),
                      rand(1, 96, 64)), scan),
    }

    def grads(call, args, dev, dtype=torch.float32):
        args = [a.to(dev, dtype).requires_grad_(True) for a in args]
        out = call(*args)
        outs = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(sum(o.float().square().sum() for o in outs), args)

    for name, (args, call) in cases.items():
        kernels.reset_launch_counts()
        got = grads(call, args, "cuda")
        torch.cuda.synchronize()
        n = kernels.launch_counts()[name]
        check(n == 1, f"{name}: {n} forward launches with grad")
        rel = _close_leaves(torch, list(got), list(grads(call, args, "cpu")), f"{name} gradients")
        print(f"{name}: gradients on the card (kernel forward, {n} launch; torch backward) == "
              f"the CPU's within 1e-4 of each input's largest entry (max rel diff {rel:.3g})",
              flush=True)

    models = {"smollm-360m": get_config("smollm-360m").reduced(),
              "zamba2-1.2b": get_config("zamba2-1.2b").reduced()}
    for arch, cfg in models.items():
        params = [transformer.init_params(cfg, torch.Generator().manual_seed(i), "cpu")
                  for i in range(2)]
        tokens = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
        batch = (tokens[:, :-1], tokens[:, 1:])
        grad_fn = torch.func.grad_and_value(transformer.loss_fn)
        kernels.reset_launch_counts()
        gpu = grad_fn(cuda(params[0]), cfg, cuda(batch))
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        want = {"rmsnorm", "flash_attention"} | ({"ssd_scan"} if "mamba2" in cfg.block_pattern else set())
        check(set(counts) == want, f"{arch} loss_fn forward launches {counts}, expected {sorted(want)}")
        cpu = grad_fn(params[0], cfg, batch)
        rel = _close_leaves(torch, [gpu[1], *tree_leaves(gpu[0])], [cpu[1], *tree_leaves(cpu[0])],
                            f"{arch} loss_fn gradients")
        print(f"{arch} reduced ({cfg.n_layers} blocks) loss_fn: loss {float(gpu[1]):.6f} (CPU "
              f"{float(cpu[1]):.6f}); gradients of {len(tree_leaves(cpu[0]))} leaves on the card "
              f"== the CPU's (max rel diff {rel:.3g}); forward launches {counts}", flush=True)

        stacked = cuda(tree_map(lambda *ts: torch.stack(ts), *params))
        kernels.reset_launch_counts()
        vg, vl = torch.func.vmap(grad_fn, in_dims=(0, None, None))(stacked, cfg, cuda(batch))
        torch.cuda.synchronize()
        vcounts = {k: v for k, v in kernels.launch_counts().items() if v}
        check(set(vcounts) == want, f"{arch} vmapped loss_fn launches {vcounts}")
        worst = 0.0
        for i in range(2):
            g_i, l_i = grad_fn(cuda(params[i]), cfg, cuda(batch))
            worst = max(worst, _close_leaves(
                torch, [vl[i], *(t[i] for t in tree_leaves(vg))], [l_i.cpu(), *tree_leaves(g_i)],
                f"{arch} vmap(grad_and_value) client {i}"))
        print(f"{arch}: vmap(grad_and_value(loss_fn)) over 2 clients on the card == a loop "
              f"(max rel diff {worst:.3g}); launches {vcounts}", flush=True)

    # bf16 on the card: finite gradients; kernel 8 under a decay of -0.75 a step.
    kernels.reset_launch_counts()
    bad = []
    for name, (args, call) in cases.items():
        if name == "ssd_scan":
            args = (args[0], torch.full_like(args[1], -0.75), args[2], args[3])
        for t in grads(call, args, "cuda", torch.bfloat16):
            if not bool(torch.isfinite(t.float()).all()):
                bad.append(name)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(not bad and all(counts[n] == 1 for n in cases), f"bf16 gradients: not finite {bad}, {counts}")
    print(f"bf16 gradients on the card finite, kernel 8 at a decay of -0.75 a step; launches "
          f"{ {n: counts[n] for n in cases} }", flush=True)


def sampler_scale_phase(torch, kernels) -> int:
    """(j) the reference's million-client sampler round
    (``benchmarks/run.py:bench_fed_sampler_scale``): K-Vib with K=64 and a
    one-shard ``ShardSpec``, the sharded solve, the Bernoulli draw and the
    feedback update, at N = 10^4, 10^5, 10^6.  Host clock around ``reps``
    rounds ending in a synchronize, after two warm-up rounds.  Checks that
    each round launches kernel 5 five times, that p is finite with sum K,
    and how far the sharded solve is from the unsharded one on the same
    state.  Returns the launches."""
    from repro_torch.core import make_sampler, solver
    from repro_torch.launch.mesh import ShardSpec

    dev = torch.device("cuda")
    k = 64
    total, per_client = 0, {}
    for n in (10_000, 100_000, 1_000_000):
        sampler = make_sampler("kvib", n=n, budget=k, horizon=100, shard=ShardSpec())
        gen = torch.Generator(device=dev).manual_seed(n)

        def sampler_round(state):
            p = sampler.probabilities(state)
            draw = sampler.sample_from(p, torch.rand(n, generator=gen, device=dev))
            return sampler.update(state, draw, draw.mask * p), p

        state = sampler.init(dev)
        for _ in range(2):
            state, _ = sampler_round(state)
        torch.cuda.synchronize()
        reps = 20
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, p = sampler_round(state)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / reps * 1e6
        launched = kernels.launch_counts()["waterfill_level_stats"]
        check(launched == LADDER_PASSES * reps, f"(j) N={n}: {launched} launches in {reps} rounds")
        total += launched
        check(bool(torch.isfinite(p).all()) and abs(float(p.sum()) - k) < 1e-3 * k,
              f"(j) N={n}: sum(p) = {float(p.sum())}")
        gamma = torch.clamp(state.aux[0], min=1e-12)
        scores = torch.sqrt(state.stats + gamma)
        sharded = solver.isp_probabilities_unchecked(scores, k, 0.0, shard=ShardSpec())
        plain = solver.isp_probabilities_unchecked(scores, k, 0.0)
        diff = float((sharded - plain).abs().max())
        check(diff <= 1e-6 * float(plain.max()), f"(j) N={n}: sharded solve off by {diff}")
        # Whether each solve, and the prefix sum both snap from, repeats
        # bitwise on the card: the S=1 bitwise claim rests on them.
        sorted_scores = torch.sort(scores).values
        repeats = {
            "unsharded solve": torch.equal(plain, solver.isp_probabilities_unchecked(scores, k, 0.0)),
            "sharded solve": torch.equal(
                sharded, solver.isp_probabilities_unchecked(scores, k, 0.0, shard=ShardSpec())),
            "cumsum": all(torch.equal(torch.cumsum(sorted_scores, 0), torch.cumsum(sorted_scores, 0))
                          for _ in range(10)),
        }
        per_client[n] = us / n
        print(f"(j) sampler round N={n} K={k}: {us:.1f} us/round, {us / n:.6f} us/client, "
              f"{launched // reps} launches of waterfill_level_stats a round, "
              f"sharded vs unsharded solve max_abs_diff={diff:.3g} "
              f"(bitwise {torch.equal(sharded, plain)}); bitwise repeatable: {repeats}", flush=True)
    print(f"(j) us/client N=1e6 over N=1e4: {per_client[1_000_000] / per_client[10_000]:.3f}x")
    return total


def ops_call(torch, api, kernels) -> int:
    """``kernels.ops.aggregate_cohort_updates`` on a stacked (C=10) delta dict
    of the tiny LM's parameters: one launch of kernel 3, the estimate and
    norms of its plain version.  Returns the launches."""
    from repro_torch.core.estimator import flatten_stacked
    from repro_torch.fed.tasks import tree_leaves, tree_map
    from repro_torch.kernels import ops, ref
    from repro_torch.rng import PhiloxSource

    _, lm, _ = path_specs(api)[1]
    built = api.build(lm)
    params = PhiloxSource(0, built.device).init_params(built.task)
    gen = torch.Generator(device=built.device).manual_seed(1)
    deltas = tree_map(
        lambda p: 0.01 * torch.randn((10,) + tuple(p.shape), generator=gen, device=p.device), params
    )
    w = torch.rand(10, generator=gen, device=built.device)
    kernels.reset_launch_counts()
    est, sq = ops.aggregate_cohort_updates(deltas, w)
    counts = kernels.launch_counts()
    want = {k: int(k == "fused_weighted_agg") for k in counts}
    check(counts == want, f"kernels.ops: kernel launches {counts}, expected {want}")
    d_want, sq_want = ref.weighted_agg_reference(flatten_stacked(deltas)[0], w)
    got = torch.cat([leaf.reshape(-1) for leaf in tree_leaves(est)])
    torch.testing.assert_close(got, d_want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sq, sq_want, rtol=1e-4, atol=0.0)
    print(f"kernels.ops.aggregate_cohort_updates: C=10 D={got.numel()} "
          f"max_abs_err={float((got - d_want).abs().max()):.3g} launches={counts}", flush=True)
    return counts["fused_weighted_agg"]


def count_round_syncs(torch, api, spec, rounds: int = 2) -> list:
    """Host syncs inside the round body (``torch.cuda`` sync debug mode) over
    ``rounds`` rounds after a warm-up round: the compiled loop keeps its
    metrics on the device, so a round should need none."""
    import warnings

    from repro_torch.fed import server
    from repro_torch.rng import PhiloxSource

    built = api.build(spec)
    cfg, dev = built.fed_config, built.device
    source = PhiloxSource(0, dev)
    carry = server.init_carry(built.task, built.sampler, cfg, source, dev)
    body = server._build_round_body(built.task, built.dataset, built.sampler, cfg, None, source)
    carry, _ = body(0, carry)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for t in range(1, 1 + rounds):
                carry, _ = body(t, carry)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def count_sampler_syncs(torch, rounds: int = 2) -> list:
    """Host syncs in (j)'s sampler round at N = 10^6, after a warm-up round."""
    import warnings

    from repro_torch.core import make_sampler
    from repro_torch.launch.mesh import ShardSpec

    dev, n = torch.device("cuda"), 1_000_000
    sampler = make_sampler("kvib", n=n, budget=64, horizon=100, shard=ShardSpec())
    gen = torch.Generator(device=dev).manual_seed(0)

    def sampler_round(state):
        p = sampler.probabilities(state)
        draw = sampler.sample_from(p, torch.rand(n, generator=gen, device=dev))
        return sampler.update(state, draw, draw.mask * p)

    state = sampler_round(sampler.init(dev))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(rounds):
                state = sampler_round(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def profile_kernels(torch, fn, label: str, note: str, top: int = 8) -> dict:
    """Run ``fn`` under torch.profiler and print the device's busy share of
    the wall time and the kernels that take the device time.  Returns the
    device µs and the launches of each kernel, by name (empty where the
    profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernel events only: an aten op's self device time repeats its kernels'.
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not kernels:
        print(f"trace {label}: the profiler recorded no kernel time (not measured)")
        return {}
    device_us = sum(e.self_device_time_total for e in kernels)
    print(
        f"trace {label}: wall_s={wall:.4f} kernel_busy_s={device_us / 1e6:.4f} "
        f"busy_share={device_us / 1e6 / wall:.3%} ({note}, under the profiler, "
        f"{sum(e.count for e in kernels)} kernel launches)"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {e.key: (e.self_device_time_total, e.count) for e in kernels}


def serve_trace(torch, engine, label: str) -> dict:
    """A served engine again ((k)'s or (m)'s): host syncs in 8 decode steps
    (``torch.cuda`` sync debug mode; the one synchronize that ends each
    ``step`` call is not an implicit sync and is not flagged), then one
    prefill and 16 decode steps under the profiler, and kernel 6's device
    time a launch in those decode steps (the profiler's, free of the event
    timer's floor).  Returns the syncs and the prefill's device µs and
    launches per kernel."""
    import warnings

    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, engine.cfg.vocab, (engine.batch, 512), generator=gen, device="cuda")
    engine.start(prompts)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.step(8)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    print(f"{label} serve: host syncs in 8 decode steps: {len(syncs)} ({len(syncs) / 8:.2f} a step) "
          f"{sorted(set(syncs))[:4]}")
    prefill = profile_kernels(torch, lambda: engine.start(prompts), f"{label} prefill 8x512",
                              f"one prefill: {engine.cfg.n_layers} blocks", top=10)
    t0 = engine.decode_seconds
    decode = profile_kernels(torch, lambda: engine.step(16), f"{label} decode",
                             "16 decode steps of 8 tokens", top=10)
    print(f"{label} decode under the profiler: "
          f"{16 * engine.batch / (engine.decode_seconds - t0):.1f} tokens/s")
    rms = [v for key, v in decode.items() if "rmsnorm" in key]
    if rms:
        us, n = sum(v[0] for v in rms), sum(v[1] for v in rms)
        print(f"{label} decode: kernel 6 (rmsnorm) device time a launch {us / n:.3f} us "
              f"over {n} launches in 16 steps (profiler)")
    return syncs, prefill


def trace_phase(torch, engines):
    """Host syncs per round and per decode step, then one more tiny_lm
    oracle run and the prefill and decode of (k) and (m) under
    torch.profiler: the device's busy share of the wall time, the kernels
    that take the device time and kernel 8's share of (m)'s prefill.  (m)
    must make no host sync in its decode steps."""
    phase("trace")
    from repro_torch import api

    for label, spec, _ in path_specs(api):
        syncs = count_round_syncs(torch, api, spec)
        print(f"{label}: host syncs in 2 rounds of the round body: {len(syncs)} "
              f"{sorted(set(syncs))[:4]}")
    syncs = count_sampler_syncs(torch)
    print(f"(j) sampler round N=10^6: host syncs in 2 rounds: {len(syncs)} {sorted(set(syncs))[:4]}")

    _, spec, _ = path_specs(api)[1]
    built = api.build(spec)
    profile_kernels(torch, lambda: api.run(spec, built=built), "tiny_lm oracle", f"{ROUNDS} rounds")
    serve_trace(torch, engines["k"], "(k)")
    prefill_ab(torch, engines["k"], "(k)")
    syncs, prefill = serve_trace(torch, engines["m"], "(m)")
    prefill_ab(torch, engines["m"], "(m)")
    check(not syncs, f"(m): {len(syncs)} host syncs in 8 decode steps")
    if prefill:
        ssd_us = sum(v[0] for key, v in prefill.items() if "ssd_scan_kernel" in key)
        total_us = sum(v[0] for v in prefill.values())
        print(f"(m) prefill: kernel 8 (ssd_scan) {ssd_us / 1e3:.3f} ms of {total_us / 1e3:.3f} "
              f"ms of kernel time ({ssd_us / total_us:.1%})")


def _leaves(tree):
    return [t for _, t in _named_leaves(tree)]


# -- 5. agreement with the plain path -----------------------------------------


def agreement_phase(torch):
    phase("agreement")
    import numpy as np

    from repro_torch import api
    from repro_torch.rng import ReplaySource

    rng = np.random.default_rng(0)
    n, rounds, steps, batch = 12, 3, 2, 16
    for oracle, comp in ((True, None), (False, None), (True, "int8"), (False, "int8")):
        spec = api.ExperimentSpec(
            task=api.TaskSpec(
                name="logreg", dataset="synthetic_classification",
                dataset_kwargs=dict(n_clients=n, total=1200, power=2.0, seed=1),
            ),
            sampler=api.SamplerSpec(name="kvib", kwargs={"horizon": rounds}),
            federation=api.FederationSpec(
                rounds=rounds, budget=3, cohort=4, local_steps=steps, batch_size=batch, local_lr=0.05
            ),
            execution=api.ExecutionSpec(seed=1, oracle_metrics=oracle),
            compression=api.CompressionSpec(delta_dtype=comp),
        )
        built = api.build(spec, "cpu")
        sizes = built.dataset.sizes.numpy()
        tables = dict(
            init_params={"w": rng.normal(0, 0.01, (60, 10)).astype(np.float32),
                         "b": np.zeros(10, np.float32)},
            uniforms=rng.uniform(size=(rounds, n)).astype(np.float32),
            priorities=rng.uniform(size=(rounds, n)).astype(np.float32),
            batch_idx=(rng.uniform(size=(rounds, n, steps, batch)) * sizes[:, None, None]).astype(np.int64),
        )
        runs = {
            dev: api.run(spec, dev, random_source=ReplaySource(**tables, device=dev))
            for dev in ("cpu", "cuda")
        }
        cpu, gpu = runs["cpu"], runs["cuda"]
        check(cpu.cohort_size == gpu.cohort_size, f"cohort sizes {cpu.cohort_size} vs {gpu.cohort_size}")
        np.testing.assert_allclose(gpu.train_loss, cpu.train_loss, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gpu.estimator_sq_error, cpu.estimator_sq_error, rtol=1e-4, atol=1e-6)
        # Compressed: the deltas differ by float rounding between devices, and
        # a code flips where a scaled value sits on a rounding boundary, so a
        # parameter may differ by one int8 step: 1/127 of the run's largest
        # parameter movement, not f32 rounding.
        final = _leaves(cpu.final_params)
        movement = max(float(np.abs(f - i).max()) for f, i in zip(final, _leaves(tables["init_params"])))
        atol = movement / 127.0 if comp else 1e-5
        diff = 0.0
        for a, b in zip(_leaves(gpu.final_params), final):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
            diff = max(diff, float(np.abs(a - b).max()))
        print(
            f"{'oracle' if oracle else 'deployable'} {comp or 'f32'} deltas: GPU run == CPU run "
            f"(params max_abs_diff={diff:.3g}, atol={atol:.3g}; loss {gpu.train_loss}, "
            f"cohort {gpu.cohort_size})",
            flush=True,
        )
    full_size_agreement(torch, api, np, rng)
    serve_agreement(torch)
    hybrid_agreement(torch)


def serve_agreement(torch):
    """A 2-layer smollm-360m at full width in f32, served on the GPU and on
    the CPU (plain path) from the same weights and prompts (4 x 200 tokens,
    a ragged S for kernel 7, then 7 decode steps): the same greedy tokens,
    logits within 1e-4.  Then bf16 on the GPU: prefill + paged decode
    against the full forward (teacher forcing) within the reference's serve
    tolerance, 2e-2."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2, param_dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 200), generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, batch=4, max_seq=208, page_size=16, device=dev)
        eng.start(prompts)
        first = eng.last_logits.cpu()
        eng.step(7)
        runs[dev] = (first, eng.last_logits.cpu(), eng.generated().cpu())
    (f_cpu, l_cpu, g_cpu), (f_gpu, l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    check(torch.equal(g_cpu, g_gpu), f"served tokens differ: GPU {g_gpu.tolist()} CPU {g_cpu.tolist()}")
    torch.testing.assert_close(f_gpu, f_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-4, atol=1e-4)
    print(f"serve smollm-360m full width 2 layers f32: GPU == CPU greedy tokens {tuple(g_gpu.shape)}, "
          f"prefill logits max_abs_diff={float((f_gpu - f_cpu).abs().max()):.3g}, last decode "
          f"logits max_abs_diff={float((l_gpu - l_cpu).abs().max()):.3g}", flush=True)

    cfg16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    p16 = transformer.init_params(cfg16, gen, "cuda")
    toks = torch.randint(0, cfg.vocab, (4, 203), generator=gen, device="cuda")
    full, _ = transformer.forward(p16, cfg16, toks)
    pre, caches = transformer.prefill(p16, cfg16, toks[:, :200], max_seq=204, page_size=16)
    diffs = [float((pre[:, 0].float() - full[:, 199].float()).abs().max())]
    torch.testing.assert_close(pre[:, 0].float(), full[:, 199].float(), rtol=2e-2, atol=2e-2)
    for i in range(3):
        dec, caches = transformer.decode_step(p16, cfg16, toks[:, 200 + i : 201 + i], caches, 200 + i)
        torch.testing.assert_close(dec[:, 0].float(), full[:, 200 + i].float(), rtol=2e-2, atol=2e-2)
        diffs.append(float((dec[:, 0].float() - full[:, 200 + i].float()).abs().max()))
    print(f"serve bf16 on the GPU: prefill + 3 paged decode steps == full forward within 2e-2 "
          f"(max_abs_diff per step {[f'{d:.3g}' for d in diffs]})", flush=True)


def hybrid_agreement(torch):
    """zamba2-1.2b at full width (d_model 2048, 64 SSM heads of 64, N 64,
    32 attention heads, d_ff 8192, vocab 32,000) cut from 38 blocks to a
    (mamba2, mamba2, shared_attn) pattern of 3, in f32, served on the GPU
    (kernels 6, 7 and 8) and on the CPU (their plain versions) from the
    same weights and prompts: 4 x 200 tokens (the model's chunk rule gives
    chunks of 8 there) and 7 decode steps.  The same greedy tokens; prefill
    and last decode logits within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=3,
                              block_pattern=("mamba2", "mamba2", "shared_attn"),
                              param_dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 200), generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, batch=4, max_seq=208, page_size=16, device=dev)
        eng.start(prompts)
        first = eng.last_logits.cpu()
        eng.step(7)
        runs[dev] = (first, eng.last_logits.cpu(), eng.generated().cpu())
        del eng
    (f_cpu, l_cpu, g_cpu), (f_gpu, l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    check(torch.equal(g_cpu, g_gpu), f"hybrid tokens differ: GPU {g_gpu.tolist()} CPU {g_cpu.tolist()}")
    torch.testing.assert_close(f_gpu, f_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-4, atol=1e-4)
    print(f"serve zamba2 full width 3 layers (mamba2, mamba2, shared_attn) f32: GPU == CPU greedy tokens "
          f"{tuple(g_gpu.shape)}, prefill logits max_abs_diff={float((f_gpu - f_cpu).abs().max()):.3g}, "
          f"last decode logits max_abs_diff={float((l_gpu - l_cpu).abs().max()):.3g} "
          f"(logits up to {float(f_cpu.abs().max()):.3g})", flush=True)
    del params
    torch.cuda.empty_cache()


def full_size_agreement(torch, api, np, rng):
    """Runs (g) and (h) at their full size: the GPU run (sharded solve on the
    kernel ladder) equals the CPU run (plain path, bisection bracket) fed the
    same recorded draws, fault draws included."""
    from repro_torch.fed.tasks import params_to_numpy
    from repro_torch.rng import ReplaySource

    for label, spec, _ in path_specs(api):
        if not label.startswith(("(g)", "(h)")):
            continue
        built = api.build(spec, "cpu")
        cfg, n = built.fed_config, built.dataset.n_clients
        sizes = built.dataset.sizes.numpy()
        t, r, b = cfg.rounds, cfg.local_steps, cfg.batch_size
        tables = dict(
            init_params=params_to_numpy(built.task.init(torch.Generator().manual_seed(0), "cpu")),
            uniforms=rng.uniform(size=(t, n)),
            priorities=rng.uniform(size=(t, n)),
            batch_idx=(rng.uniform(size=(t, n, r, b)) * sizes[:, None, None]).astype(np.int64),
        )
        if cfg.faults is not None:
            width = n if cfg.oracle_metrics else cfg.cohort_slots(n)
            tables.update(avail_uniforms=rng.uniform(size=(t, n)),
                          latencies=rng.exponential(size=(t, width)),
                          async_latencies=rng.exponential(size=t))
        cpu, gpu = (api.run(spec, dev, random_source=ReplaySource(**tables, device=dev))
                    for dev in ("cpu", "cuda"))
        check(cpu.cohort_size == gpu.cohort_size, f"{label}: cohort sizes differ")
        check(cpu.deadline_dropped == gpu.deadline_dropped, f"{label}: deadline drops differ")
        np.testing.assert_allclose(gpu.train_loss, cpu.train_loss, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gpu.estimator_sq_error, cpu.estimator_sq_error, rtol=1e-4, atol=1e-6)
        diff = 0.0
        for a, c in zip(_leaves(gpu.final_params), _leaves(cpu.final_params)):
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)
            diff = max(diff, float(np.abs(a - c).max()))
        print(f"{label}: GPU run == CPU run on the same draws (params max_abs_diff={diff:.3g}; "
              f"loss {gpu.train_loss}; cohort {gpu.cohort_size}; "
              f"deadline_dropped {gpu.deadline_dropped})", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    ap.add_argument("--only", nargs="+", default=[], metavar="PHASE",
                    help="run only the build and these phases, in this order, and print no "
                    "result line: kernels, ranks, model_axis, dryrun, remat (its default cells) or "
                    f"remat=CELLS (comma-separated of {','.join(REMAT_CELLS)})")
    ap.add_argument("--ranks-worker", nargs=4, metavar=("RANK", "PORT", "SPECS", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--model-axis-worker", nargs=3, metavar=("RANK", "PORT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ranks_worker:
        rank, port, specs, out = args.ranks_worker
        return ranks_worker(int(rank), int(port), specs, out)
    if args.model_axis_worker:
        rank, port, out = args.model_axis_worker
        return model_axis_worker(int(rank), int(port), out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible; nothing was run", file=sys.stderr)
        return 2
    card = device_phase(torch)
    build_phase()
    only = [name.partition("=")[0] for name in args.only]
    start_cpu_jobs([k for k in CPU_JOBS if not only
                    or (k.startswith("dryrun") and "dryrun" in only and k.count(" ") == 2)
                    or (k in dict(MA_CLI) and "model_axis" in only)])
    if args.only:
        for name in args.only:
            name, _, cells = name.partition("=")
            if name == "kernels":
                kernel_phase(torch)
            elif name == "ranks":
                ranks_phase(torch, card)
            elif name == "model_axis":
                model_axis_phase(torch, card)
            elif name == "dryrun":
                dryrun_phase(torch, card)
            elif name == "remat":
                remat_phase(torch, card, [c for c in cells.split(",") if c] or REMAT_DEFAULT)
            else:
                raise SystemExit(f"chip_smoke: unknown phase {name!r} in --only")
        return 0
    rows, max_err, path_shape = kernel_phase(torch)
    ranks_launches_ = ranks_phase(torch, card)
    launches, engines = path_phase(torch)
    for k, v in ranks_launches_.items():
        launches[k] += v
    for k, v in samplers_phase(torch, card).items():
        launches[k] += v
    for k, v in examples_phase(torch, card).items():
        launches[k] += v
    for k, v in checkpoint_phase(torch).items():
        launches[k] += v
    for k, v in zoo_phase(torch, card).items():
        launches[k] += v
    for k, v in serve_loop_phase(torch, card).items():
        launches[k] += v
    for k, v in zoo_families_phase(torch, card).items():
        launches[k] += v
    for k, v in zoo_frontends_phase(torch, card).items():
        launches[k] += v
    remat_phase(torch, card)
    lint_phase(torch)
    # After the lint: the CPU jobs it waits for (the dry run of one chip of
    # (16, 16) and (2, 16, 16)) have ended by then.
    for k, v in model_axis_phase(torch, card).items():
        launches[k] += v
    dryrun_phase(torch, card)
    autograd_phase(torch)
    agreement_phase(torch)
    trace_phase(torch, engines)

    kernels = []
    for name, (label, dtype) in path_shape.items():
        row = rows[(name, label, dtype)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": row["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
