"""One rank's share of the port's model steps over a gloo group, for
``tests/test_torch_model_axis.py``.

``python tests/torch_model_axis_worker.py RANK WORLD PORT CASES.json OUT_DIR``
joins a ``WORLD``-rank gloo group at ``tcp://127.0.0.1:PORT`` and runs each
case of the JSON list under ``models.sharding.use_rules`` on its mesh,
writing ``OUT_DIR/<name>_r<RANK>.npz``.  The parent test imports
``whole_case`` and computes each case unsplit.  Imports no JAX.

A case is a dict: ``name``; ``kind`` (``loss_grad``: ``loss_fn`` and its
``torch.func`` gradient gathered whole; ``round``: one client_parallel
``build_round_step``; ``prefill_decode``; ``prefill``; ``a2a_ref``: the
a2a MoE on the reference's weights; ``run``: ``api.run`` of ``spec`` on its
``mesh_shape``, by ``torch_ranks_worker.run_case``); ``arch`` and
``kwargs`` (a reduced config), ``remat``, ``moe_impl``, ``aux_coef``;
``mesh`` (the mesh shape); ``fsdp``; ``rows`` (whether this rank takes its
block of the batch rows, as the rules' ``batch`` axes say); ``seed``.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree.detach().float().numpy()}


def config(case):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    # The a2a's aux is the mean of the shards' local estimates, not the
    # whole batch's (the reference's definition): its cases drop the aux
    # term and hold the aux against the reference's a2a instead.
    transformer.MOE_AUX_COEF = case.get("aux_coef", 0.01)

    cfg = get_config(case["arch"]).reduced(**case.get("kwargs", {}))
    over = {k: case[k] for k in ("remat", "moe_impl") if k in case}
    return dataclasses.replace(cfg, **over) if over else cfg


def params(case, cfg):
    from repro_torch.models import transformer

    gen = torch.Generator().manual_seed(case.get("seed", 0))
    p = transformer.init_params(cfg, gen, "cpu")
    if cfg.frontend:  # open the vlm's gates so that the cross path is seen
        for j, kind in enumerate(cfg.block_pattern):
            if kind == "cross_attn":
                p["stacks"][j]["gate"] = torch.full_like(p["stacks"][j]["gate"], 0.5)
    return p


def inputs(case, cfg):
    """(tokens, targets[, aux_embeds]) (B, S) from the case's seed."""
    rng = np.random.default_rng(case.get("seed", 0) + 1)
    b, s = case.get("batch", 4), case.get("seq", 8)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    out = [tok, tgt]
    if cfg.frontend:
        fd = cfg.frontend_dim or cfg.d_model
        out.append(torch.from_numpy(rng.standard_normal((b, cfg.frontend_seq, fd))
                                    .astype(np.float32)))
    return tuple(out)


def round_inputs(case, cfg):
    rng = np.random.default_rng(case.get("seed", 0) + 2)
    c, r, b, s = case["cohort"], 2, 2, case.get("seq", 8)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (c, r, b, s)))
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab, (c, r, b, s)))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (c,)).astype(np.float32))
    return tok, tgt, w


def whole_case(case) -> dict:
    """The case unsplit (no rules): name -> numpy array."""
    from repro_torch.fed.round import RoundSpec, build_round_step
    from repro_torch.models import transformer

    cfg = config(case)
    p = params(case, cfg)
    kind = case["kind"]
    if kind == "loss_grad":
        batch = inputs(case, cfg)
        grads, loss = torch.func.grad_and_value(
            lambda q: transformer.loss_fn(q, cfg, batch))(p)
        return {"loss": loss.detach().numpy(), **{f"g.{k}": v for k, v in _flat(grads).items()}}
    if kind == "round":
        step = build_round_step(cfg, RoundSpec(cohort=case["cohort"], local_steps=2,
                                               local_batch=2, local_lr=0.05))
        new, norms, loss = step(p, *round_inputs(case, cfg))
        return {"loss": loss.numpy(), "norms": norms.numpy(),
                **{f"p.{k}": v for k, v in _flat(new).items()}}
    if kind == "prefill_decode":
        batch = inputs(case, cfg)
        tok, aux = batch[0], (batch[2] if cfg.frontend else None)
        s = tok.shape[1]
        logits, caches = transformer.prefill(p, cfg, tok[:, : s - 2], aux, max_seq=s)
        l1, caches = transformer.decode_step(p, cfg, tok[:, s - 2 : s - 1], caches, s - 2)
        full, _ = transformer.forward(p, cfg, tok, aux)
        return {"prefill": logits.numpy(), "decode": l1.numpy(), "forward": full.detach().numpy()}
    if kind == "prefill":
        logits, _ = transformer.prefill(p, cfg, inputs(case, cfg)[0])
        return {"prefill": logits.numpy()}
    raise ValueError(kind)


def a2a_against_reference(case) -> dict:
    """The port's ``_moe_ffn_a2a`` on the reference's weights and input
    (``case["ref"]``, an npz the reference wrote), this rank's E/M experts;
    with the routing of this rank's token slice (top-k ids, the first
    pack's slots and kept rows) by the port's ``route`` pieces."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    ref = np.load(case["ref"])
    cfg = config(case)
    mesh = make_mesh(case["mesh"])
    group = mesh.axis_group("model")
    e_loc = cfg.n_experts // group.size
    blk = slice(group.rank * e_loc, (group.rank + 1) * e_loc)
    p = {"router": torch.from_numpy(ref["router"])}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = torch.from_numpy(np.ascontiguousarray(ref[k][blk]))
    x = torch.from_numpy(ref["x"])
    out, aux = moe._moe_ffn_a2a(p, cfg, x, group)
    s_loc = x.shape[1] // group.size
    xf = x[:, group.rank * s_loc:(group.rank + 1) * s_loc].reshape(-1, cfg.d_model)
    gates = torch.softmax(xf @ p["router"], dim=-1)
    _, top_idx = torch.topk(gates, cfg.top_k, dim=-1)
    flat = top_idx.reshape(-1)
    cap_pair, _ = moe._a2a_caps(cfg, xf.shape[0], group.size)
    _, slot, kept = moe._pack_by_dest(torch.repeat_interleave(xf, cfg.top_k, 0),
                                      torch.div(flat, e_loc, rounding_mode="floor"),
                                      group.size, cap_pair)
    return {"out": out.numpy(), "aux": aux.numpy(), "top_idx": top_idx.numpy(),
            "slot": slot.numpy(), "kept": kept.numpy(), "cap_pair": np.asarray(cap_pair)}


def rank_case(case) -> dict:
    """The case as this rank's share under ``use_rules`` on its mesh."""
    from repro_torch.fed.round import RoundSpec, build_round_step
    from repro_torch.launch import sharding as lsh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding, transformer

    if case["kind"] == "a2a_ref":
        return a2a_against_reference(case)
    if case["kind"] == "run":  # api.run on the mesh (its spec's mesh_shape)
        import torch_ranks_worker

        return torch_ranks_worker.run_case(case)
    cfg = config(case)
    mesh = make_mesh(case["mesh"])
    fsdp = bool(case.get("fsdp"))
    whole = params(case, cfg)
    specs = lsh.param_specs(whole, mesh, fsdp)
    p = lsh.param_shardings(whole, mesh, fsdp)
    kind = case["kind"]
    rules = lsh.activation_rules(mesh, client_parallel=(kind == "round"))
    if not case.get("rows"):
        rules["batch"] = None
    with sharding.use_rules(mesh, rules, fsdp=fsdp):
        if kind == "loss_grad":
            batch = inputs(case, cfg)
            if case.get("rows"):
                rows = sharding.batch_group()
                b = batch[0].shape[0] // rows.size
                batch = tuple(x[rows.rank * b:(rows.rank + 1) * b] for x in batch)
            grads, loss = torch.func.grad_and_value(
                lambda q: transformer.loss_fn(q, cfg, batch))(p)
            grads = lsh.gather_params(grads, specs, mesh)
            return {"loss": loss.detach().numpy(),
                    **{f"g.{k}": v for k, v in _flat(grads).items()}}
        if kind == "round":
            step = build_round_step(cfg, RoundSpec(cohort=case["cohort"], local_steps=2,
                                                   local_batch=2, local_lr=0.05))
            new, norms, loss = step(p, *round_inputs(case, cfg))
            new = lsh.gather_params(new, specs, mesh)
            return {"loss": loss.numpy(), "norms": norms.numpy(),
                    **{f"p.{k}": v for k, v in _flat(new).items()}}
        if kind == "prefill_decode":
            batch = inputs(case, cfg)
            tok, aux = batch[0], (batch[2] if cfg.frontend else None)
            s = tok.shape[1]
            logits, caches = transformer.prefill(p, cfg, tok[:, : s - 2], aux, max_seq=s)
            l1, caches = transformer.decode_step(p, cfg, tok[:, s - 2 : s - 1], caches, s - 2,
                                                 max_seq=s)
            full, _ = transformer.forward(p, cfg, tok, aux)
            return {"prefill": logits.numpy(), "decode": l1.numpy(),
                    "forward": full.detach().numpy()}
        if kind == "prefill":  # one prefill, for the dry run's count of its collectives
            logits, _ = transformer.prefill(p, cfg, inputs(case, cfg)[0])
            return {"prefill": logits.numpy()}
    raise ValueError(kind)


def main(argv) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh

    rank, world, port = int(argv[1]), int(argv[2]), int(argv[3])
    with open(argv[4]) as f:
        cases = json.load(f)
    out_dir = argv[5]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        for case in cases:
            mesh.reset_collective_counts()
            out = rank_case(case)
            counts = mesh.collective_counts()
            out["collectives"] = np.asarray([counts[k] for k in sorted(counts)])
            np.savez(os.path.join(out_dir, f"{case['name']}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
