"""Serving launcher: paged-KV-cache decode from fresh weights (the port of
``repro/launch/serve.py``, demo mode).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 8 --prompt-len 512 --new-tokens 64 --page-size 16

runs on the GPU: it initializes the model in its ``param_dtype`` from
``--seed``, prefills a random prompt batch (kernels 6 and 7, and kernel 8
for the hybrid's Mamba2 blocks), decodes ``--new-tokens - 1`` steps over the
paged cache (kernel 6) and prints the times, tokens/s, kernel launches and
the generated ids.  ``--arch zamba2-1.2b`` serves the hybrid at full width
and depth (38 blocks, 1.05B parameters, bf16).  ``--device cpu``
runs the plain PyTorch path instead; without a GPU and without that flag it
raises.  ``--reduced`` serves the arch's tiny same-family variant.

Follow mode (``--follow CKPT_DIR``, the serve side of the train-to-serve
loop) needs the checkpoint manager and is not ported yet.

Random streams: the parameters, the prompts and the engine's sampling each
draw from their own generator, seeded from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Paged-KV-cache serving from fresh weights (demo mode)"
    )
    ap.add_argument(
        "--follow", default="", metavar="CKPT_DIR",
        help="follow a checkpoint directory (not ported yet: needs the checkpoint manager)",
    )
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.follow:
        raise NotImplementedError(
            "--follow needs the checkpoint manager, which is not ported to repro_torch yet; "
            "see ROADMAP.md, 'Checkpointing' and 'Zoo models, serving and the zoo round'"
        )
    return _demo(args)


if __name__ == "__main__":
    main()
