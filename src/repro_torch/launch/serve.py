"""Serving launcher: paged-KV-cache decode, standalone or following a
trainer (the port of ``repro/launch/serve.py``).

Demo mode, decode from fresh weights::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 8 --prompt-len 512 --new-tokens 64 --page-size 16

runs on the GPU: it initializes the model in its ``param_dtype`` from
``--seed``, prefills a random prompt batch (kernels 6 and 7, and kernel 8
for the hybrid's Mamba2 blocks), decodes ``--new-tokens - 1`` steps over the
paged cache (kernel 6) and prints the times, tokens/s, kernel launches and
the generated ids.  ``--arch zamba2-1.2b`` serves the hybrid at full width
and depth (38 blocks, 1.05B parameters, bf16).  ``--reduced`` serves the
arch's tiny same-family variant.

Follow mode, the serve side of the train-to-serve loop.  Point it at the
``<ckpt>_ckpts`` directory of a running (or finished) ``python -m
repro_torch.launch.train --compiled --ckpt <ckpt> --ckpt-every N``::

  PYTHONPATH=src python -m repro_torch.launch.serve --follow /tmp/fl_ckpts

It reads ``spec.json`` from the checkpoint directory (written by the
trainer before round 0; ``--spec`` overrides), rebuilds the experiment and
the restore template from it, and serves synthetic prompt traffic while
watching the manifest: every newly committed boundary is restored
(fingerprint and structure checked, ``repro_torch.serve`` package
docstring), scored on held-out loss by the promotion gate and copied into
the engine iff it is no worse than what is being served.  Decoding never
stops for a swap, and every parameter tensor of the engine keeps its
address across swaps (checked at the end).  The serving geometry and the
gate's policy come from the spec's ``serve`` section (``api.ServeSpec``).
It exits printing the promotion log and a machine-readable summary line::

  serve summary: promotions=2 rollbacks=1 tokens=1920 tokens_per_sec=412.3 ...

``--device cpu`` runs the plain PyTorch path instead; without a GPU and
without that flag either mode raises.

Random streams: in demo mode the parameters, the prompts and the engine's
sampling each draw from their own generator, seeded from ``--seed``; in
follow mode the engine samples from ``execution.seed + 1`` and the prompts
and held-out batches come from the serving side's own generators
(``serve.gate.serving_generator``), apart from every training stream.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.fed.tasks import tree_leaves
from repro_torch.models import transformer


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _demo(args) -> dict:
    """Decode from fresh weights; returns what it printed, as a dict."""
    from repro_torch.serve import ServeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gens = [torch.Generator(device=dev).manual_seed(3 * int(args.seed) + k) for k in range(2)]
    params = transformer.init_params(cfg, gens[0], dev)
    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), generator=gens[1], device=dev
    )
    engine = ServeEngine(
        cfg,
        params,
        batch=args.batch,
        max_seq=args.prompt_len + args.new_tokens,
        page_size=args.page_size,
        temperature=args.temperature,
        seed=3 * int(args.seed) + 2,
        device=dev,
    )
    del params  # the engine holds its own copy
    _sync(dev)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine.start(prompts)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = kernels.launch_counts()
    engine.step(args.new_tokens - 1)
    launches = kernels.launch_counts()
    print(f"{cfg.name} on {dev}: {transformer.param_count(engine.params) / 1e6:.1f}M params "
          f"{cfg.param_dtype}")
    print(f"prefill {args.batch}x{args.prompt_len} in {prefill_s:.4f}s")
    print(
        f"decoded {args.new_tokens - 1} steps in {engine.decode_seconds:.4f}s "
        f"({engine.tokens_per_sec():.1f} tok/s)"
    )
    print(f"kernel launches: prefill {_nonzero(prefill_launches)}, "
          f"prefill + decode {_nonzero(launches)}")
    print("generated ids:", engine.generated().tolist())
    return {
        "engine": engine,
        "prefill_s": prefill_s,
        "decode_s": engine.decode_seconds,
        "tokens_per_sec": engine.tokens_per_sec(),
        "prefill_launches": prefill_launches,
        "launches": launches,
    }


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _load_followed_spec(ckpt_dir: str, spec_path: str, timeout: float):
    """The spec of the run being followed: ``--spec`` wins, else wait for
    the trainer's ``spec.json`` to appear in the checkpoint directory."""
    from repro_torch.api import ExperimentSpec

    if spec_path:
        return ExperimentSpec.load(spec_path)
    path = os.path.join(ckpt_dir, "spec.json")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() >= deadline:
            raise FileNotFoundError(
                f"no {path} after {timeout:.0f}s — is launch.train running "
                "with --compiled --ckpt --ckpt-every on this directory? "
                "(or pass --spec explicitly)"
            )
        time.sleep(0.1)
    return ExperimentSpec.load(path)


def follower(spec, built, manager, *, temperature: float | None = None):
    """The serving side of the loop for a built zoo spec (``api.build``),
    following ``manager``'s directory: a ``ServeSession`` over an engine on
    the round-0 weights of ``api.restore_template(spec)`` (the serve
    section's geometry, sampling seeded ``execution.seed + 1``, the
    section's temperature unless ``temperature`` is given), a gate on
    ``eval_batches`` held-out batches of ``FederationSpec.batch_size`` rows,
    a watcher restoring into the same template, and prompt traffic from
    ``serving_generator(execution.seed, 11)``.  The gate is not primed."""
    from repro_torch import api
    from repro_torch.serve import (
        CheckpointWatcher,
        PromotionGate,
        ServeEngine,
        ServeSession,
        heldout_batches,
    )
    from repro_torch.serve.gate import TRAFFIC_TAG, serving_generator

    srv, cfg, dev, seed = spec.serve, built.arch_config, built.device, spec.execution.seed
    template = api.restore_template(spec, built=built, device=dev)
    # Round-0 weights: the engine starts serving the untrained model and the
    # gate's bar is ITS held-out loss, so the first trained boundary
    # promotes iff training helped.
    engine = ServeEngine(
        cfg,
        template.params,
        batch=srv.batch,
        max_seq=srv.max_seq,
        page_size=srv.page_size,
        temperature=srv.temperature if temperature is None else temperature,
        seed=seed + 1,
        device=dev,
    )
    gate = PromotionGate(
        cfg,
        heldout_batches(built.dataset, n_batches=srv.eval_batches,
                        batch_size=spec.federation.batch_size, seed=seed),
        tolerance=srv.tolerance,
        device=dev,
    )
    traffic = serving_generator(seed, TRAFFIC_TAG)

    def prompt_fn():
        return torch.randint(0, cfg.vocab, (srv.batch, srv.prompt_len), generator=traffic)

    return ServeSession(
        engine,
        CheckpointWatcher(manager, template),
        gate,
        prompt_fn=prompt_fn,
        decode_steps_per_poll=srv.decode_steps_per_poll,
        final_step=spec.federation.rounds,
    )


def param_addresses(engine) -> list:
    """Every engine parameter's ``data_ptr()``: the compile-once contract
    kept in data (swaps copy into the engine's storage, so none moves)."""
    return [p.data_ptr() for p in tree_leaves(engine.params)]


def _follow(args) -> dict:
    """Follow a training checkpoint directory: the serve side of the loop.
    Returns the session's pieces and summary, as a dict."""
    from repro_torch import api
    from repro_torch.checkpoint import CheckpointManager, config_fingerprint

    spec = _load_followed_spec(args.follow, args.spec, args.timeout)
    built = api.build(spec, resolve_device(args.device))
    if built.arch_config is None:
        raise SystemExit(
            "--follow serves zoo runs (TaskSpec.kind='zoo'); the followed "
            f"spec has kind={spec.task.kind!r}"
        )
    manager = CheckpointManager(args.follow, fingerprint=config_fingerprint(spec.to_dict()))
    session = follower(spec, built, manager, temperature=args.temperature)
    engine, watcher, gate = session.engine, session.watcher, session.gate

    def on_decision(candidate, promoted):
        print(
            f"boundary step {candidate.step}: "
            f"{'PROMOTE' if promoted else 'ROLLBACK'} ({gate.log.records[-1].reason}); "
            f"serving at {engine.tokens_per_sec():.1f} tok/s",
            flush=True,
        )

    session.on_decision = on_decision
    print(
        f"following {args.follow} (arch={built.arch_config.name}, horizon="
        f"{spec.federation.rounds} rounds); gate bar (round-0 init) = "
        f"{gate.prime(engine.params):.4f}",
        flush=True,
    )
    ptrs = param_addresses(engine)
    summary = session.run(timeout=args.timeout, poll_timeout=args.poll)
    assert param_addresses(engine) == ptrs, "engine parameters changed address under swaps"
    print(gate.log.render())
    print("follow stats " + json.dumps({
        "restore_s": watcher.restore_seconds,
        "gate_s": gate.score_seconds,
        "gate_launches": {k: v for k, v in gate.launches.items() if v},
        "launches": {k: v for k, v in kernels.launch_counts().items() if v},
        "decode_s": engine.decode_seconds,
    }))
    print(summary.render(), flush=True)
    return {"summary": summary, "engine": engine, "gate": gate, "watcher": watcher,
            "spec": spec}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Paged-KV-cache serving: standalone demo, or --follow a "
        "training checkpoint directory with eval-gated hot swaps"
    )
    ap.add_argument(
        "--follow", default="", metavar="CKPT_DIR",
        help="follow this CheckpointManager directory (the <ckpt>_ckpts dir "
        "of launch.train --compiled --ckpt-every): hot-swap each committed "
        "boundary that clears the promotion gate",
    )
    ap.add_argument(
        "--spec", default="",
        help="ExperimentSpec JSON of the followed run (default: wait for "
        "CKPT_DIR/spec.json, which launch.train writes)",
    )
    ap.add_argument(
        "--timeout", type=float, default=120.0,
        help="follow mode: overall serving wall-clock budget (and the wait "
        "budget for spec.json to appear)",
    )
    ap.add_argument(
        "--poll", type=float, default=0.2,
        help="follow mode: manifest poll bound between decode chunks (s)",
    )
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument(
        "--temperature", type=float, default=None,
        help="sampling temperature (demo default 0.0; follow mode defaults "
        "to the spec's serve.temperature)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.follow:
        return _follow(args)
    if args.temperature is None:
        args.temperature = 0.0
    return _demo(args)


if __name__ == "__main__":
    main()
