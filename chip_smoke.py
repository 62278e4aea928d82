#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no result line):

1. device — a CUDA GPU must be visible; print its name and power limit;
2. build  — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a and print the build time;
3. kernels — hold each of the four kernels against its plain PyTorch version
   on the card at the main path's shapes (and one large shape), check that
   its norms and error scalar are bitwise repeatable, and time kernel, plain
   version, the library call computing the same function (where there is
   one) and the memory bound;
4. path — ``repro_torch.api.run(spec)`` with no device argument (so on the
   GPU) for the paper's logistic-regression spec and the tiny-LM spec in
   oracle and deployable mode, then for three compressed specs (int8 / fp8
   deltas, with and without error feedback), counting kernel launches per
   run; then ``kernels.ops.aggregate_cohort_updates`` on a stacked tiny-LM
   delta dict;
5. agreement — small runs on the GPU, uncompressed and int8-compressed,
   equal the same runs on the CPU (plain PyTorch path) fed the same recorded
   draws;
6. trace — one tiny-LM round loop under ``torch.profiler``: the device's
   busy share and the kernels that take its time.

Prints a ``{"kernels": [...]}`` JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_weighted_agg.cu"
REPLACES = {
    "fused_weighted_agg": "src/repro/kernels/fused_weighted_agg.py:134",
    "fused_multi_weighted_agg": "src/repro/kernels/fused_weighted_agg.py:174",
    "fused_cohort_agg_and_error": "src/repro/kernels/fused_weighted_agg.py:221",
    "fused_dequant_cohort_agg": "src/repro/kernels/fused_weighted_agg.py:296",
}
ROUNDS = 5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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

    info = build_library("fused_weighted_agg", force=True)
    print(f"nvcc: {info['command']}")
    print(f"built {Path(info['path']).name} in {info['seconds']:.2f} s")


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


def measure(torch, flush, kern, plain, lib, n_bytes: int, flops: int, err: float) -> dict:
    """One kernel at one shape: the times of kernel, plain version and
    library call (None where there is none), and the bound."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
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
    shapes = [  # (label, C, D): the main path's shapes, then one large ragged one
        ("oracle tiny_lm", 50, 114688),
        ("deployable tiny_lm", 10, 114688),
        ("oracle logreg", 100, 610),
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

            # Kernel 1 (M = 2) against its plain version.
            out = fwa.fused_multi_weighted_agg(g, w2c)
            want = ref.multi_weighted_agg_reference(g, w2c)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, **tol)
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
            del g, out, want, d_out, d_want, d3, d3_want
    rows.update(dequant_kernel_phase(torch, fwa, ref, gen, flush, max_err))
    return rows, max_err, path_shape


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
              f"from HBM {cold:.5f} ms ({n_bytes / cold / 1e6:.0f} GB/s), "
              f"from L2 {hot:.5f} ms ({n_bytes / hot / 1e6:.0f} GB/s)", flush=True)
        del q, scales
    return rows


# -- 4. path ------------------------------------------------------------------


def path_specs(api):
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
    dequant = "fused_dequant_cohort_agg"
    return [
        ("logreg oracle", logreg, "fused_multi_weighted_agg"),
        ("tiny_lm oracle", lm, "fused_multi_weighted_agg"),
        ("tiny_lm deployable", lm_deploy, "fused_cohort_agg_and_error"),
        ("(d) tiny_lm deployable int8+EF",
         with_sections(api, lm_deploy, compression={"delta_dtype": "int8"}), dequant),
        ("(e) tiny_lm oracle fp8+EF", with_sections(api, lm, compression={"delta_dtype": "fp8"}), dequant),
        ("(f) logreg oracle int8 no EF",
         with_sections(api, logreg, compression={"delta_dtype": "int8", "error_feedback": False}),
         dequant),
    ]


def with_sections(api, spec, **sections):
    """``spec`` with the given sections' fields replaced."""
    d = spec.to_dict()
    return api.ExperimentSpec.from_dict({**d, **{k: {**d[k], **v} for k, v in sections.items()}})


def path_phase(torch):
    phase("path")
    import numpy as np

    from repro_torch import api
    from repro_torch.kernels import fused_weighted_agg as fwa

    launches = {k: 0 for k in fwa.launch_counts()}
    for label, spec, kernel in path_specs(api):
        t0 = time.perf_counter()
        built = api.build(spec)
        build_s = time.perf_counter() - t0
        check(built.device.type == "cuda", f"{label}: default device is {built.device}")
        fwa.reset_launch_counts()
        hist = api.run(spec, built=built)
        counts = fwa.launch_counts()
        torch.cuda.synchronize()
        check(len(hist.train_loss) == ROUNDS, f"{label}: {len(hist.train_loss)} rounds")
        check(all(math.isfinite(x) for x in hist.train_loss), f"{label}: loss {hist.train_loss}")
        check(all(math.isfinite(x) for x in hist.estimator_sq_error), f"{label}: sq_error")
        for leaf in _leaves(hist.final_params):
            check(bool(np.isfinite(leaf).all()), f"{label}: non-finite parameters")
        want = {k: (ROUNDS if k == kernel else 0) for k in counts}
        check(counts == want, f"{label}: kernel launches {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        d_dim = sum(leaf.size for leaf in _leaves(hist.final_params))
        print(
            f"{label}: D={d_dim} N={built.dataset.n_clients} rounds={ROUNDS} "
            f"build_s={build_s:.3f} run_wall_s={hist.wall_time_s:.3f} "
            f"loss {hist.train_loss[0]:.4f} -> {hist.train_loss[-1]:.4f} "
            f"cohort={hist.cohort_size} launches={counts}",
            flush=True,
        )
    launches["fused_weighted_agg"] += ops_call(torch, api, fwa)
    return launches


def ops_call(torch, api, fwa) -> int:
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
    fwa.reset_launch_counts()
    est, sq = ops.aggregate_cohort_updates(deltas, w)
    counts = fwa.launch_counts()
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


def trace_phase(torch):
    """Host syncs per round, then one more tiny_lm oracle run under
    torch.profiler: the device's busy share of the run's wall time and the
    kernels that take the device time."""
    phase("trace")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api

    for label, spec, _ in path_specs(api):
        syncs = count_round_syncs(torch, api, spec)
        print(f"{label}: host syncs in 2 rounds of the round body: {len(syncs)} "
              f"{sorted(set(syncs))[:4]}")

    _, spec, _ = path_specs(api)[1]
    built = api.build(spec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.run(spec, built=built)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernel events only: an aten op's self device time repeats its kernels'.
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not kernels:
        print("trace: the profiler recorded no kernel time (not measured)")
        return
    device_us = sum(e.self_device_time_total for e in kernels)
    print(
        f"trace tiny_lm oracle: wall_s={wall:.4f} kernel_busy_s={device_us / 1e6:.4f} "
        f"busy_share={device_us / 1e6 / wall:.3%} ({ROUNDS} rounds, under the profiler, "
        f"{sum(e.count for e in kernels)} kernel launches)"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible; nothing was run", file=sys.stderr)
        return 2
    card = device_phase(torch)
    build_phase()
    rows, max_err, path_shape = kernel_phase(torch)
    launches = path_phase(torch)
    agreement_phase(torch)
    trace_phase(torch)

    kernels = []
    for name, (label, dtype) in path_shape.items():
        row = rows[(name, label, dtype)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
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
            "count": 1,  # the smoke drives one card, cuda:0
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
