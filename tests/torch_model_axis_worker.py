"""One rank's share of the port's model steps over a gloo group, for
``tests/test_torch_model_axis.py``.

``python tests/torch_model_axis_worker.py RANK WORLD PORT CASES.json OUT_DIR``
joins a ``WORLD``-rank gloo group at ``tcp://127.0.0.1:PORT`` and runs each
case of the JSON list under ``models.sharding.use_rules`` on its mesh,
writing ``OUT_DIR/<name>_r<RANK>.npz``.  The parent test imports
``whole_case`` and computes each case unsplit.  Imports no JAX.

A case is a dict: ``name``; ``kind`` (``loss_grad``: ``loss_fn`` and its
``torch.func`` gradient gathered whole, the step's collectives, and with
``routes`` each MoE block's slots and kept pairs; ``round``: one
client_parallel ``build_round_step``; ``prefill_decode``: ``serve``;
``prefill``; ``a2a_ref``: the a2a MoE on the reference's weights;
``dense_ref``: the dense MoE on the reference's weights over a batch of 3
rows split 2 / 1 (``split_rows``); ``run``: ``api.run`` of ``spec`` on
its ``mesh_shape``, by ``torch_ranks_worker.run_case``); ``arch`` and
``kwargs`` (a reduced config), ``remat``, ``moe_impl``, ``aux_coef``;
``mesh`` (the mesh shape); ``fsdp``; ``rows`` (whether this rank takes its
block of the batch rows, as the rules' ``batch`` axes say); ``batch``,
``seq``, ``steps``; ``seed``.  Outputs a rank computes on its rows are
gathered back whole over the rows' line outside the counted collectives.

Every case also writes ``gathered_whole``: the names of the watched
leaves that were the input of an all_gather.  The watched leaves are this
rank's blocks of the ``mamba2``/``mlstm`` weights ``param_specs`` splits
over ``model`` (the ones such a block consumes) and, after a prefill, of
their state leaves ``cache_shardings`` splits; ``launch.mesh.AxisGroup.
all_gather`` is wrapped to look up each input's address among them.
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


def _whole_rows(x, rows, dim: int = 0):
    """This rank's rows gathered whole over ``rows`` (an ``AxisGroup``, or
    None) by ``torch.distributed`` itself: not counted."""
    import torch.distributed as dist

    if rows is None:
        return x
    parts = [torch.empty_like(x) for _ in range(rows.size)]
    dist.all_gather(parts, x.contiguous(), group=rows.pg)
    return torch.cat(parts, dim)


_WATCH: list = []  # (first byte, end, name) of each watched leaf's storage
_GATHERED: list = []  # the watched leaves an all_gather took as its input


def _spy_gathers() -> None:
    from repro_torch.launch.mesh import AxisGroup

    real = AxisGroup.all_gather

    def all_gather(self, x, dim):
        if self.size > 1:
            at = x.data_ptr()
            _GATHERED.extend(name for lo, hi, name in _WATCH if lo <= at < hi)
        return real(self, x, dim)

    AxisGroup.all_gather = all_gather


def _watch(name: str, t) -> None:
    _WATCH.append((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(), name))


def _watch_params(cfg, p, specs) -> None:
    """This rank's blocks of the mamba2/mlstm leaves split over ``model``."""
    from repro_torch.launch import sharding as lsh
    from repro_torch.models import sharding, transformer

    for j, kind in enumerate(cfg.block_pattern):
        if kind not in transformer.HEADS_KINDS:
            continue
        parent = "ssm" if kind == "mamba2" else "cell"
        for leaf in sharding.CONSUMED[(kind, parent)]:
            if any("model" in lsh.spec_axes(e) for e in specs["stacks"][j][parent][leaf]):
                _watch(f"stacks.{j}.{parent}.{leaf}", p["stacks"][j][parent][leaf])


def _watch_states(cfg, caches, mesh, max_seq: int, batch: int) -> None:
    """This rank's blocks of the mamba2/mlstm state leaves split over
    ``model`` (the batch's split over the batch axes aside)."""
    from repro_torch.launch import sharding as lsh
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import transformer

    specs = lsh.cache_shardings(transformer.init_caches(cfg, batch, max_seq, device="meta"),
                                mesh, max_seq, batch)
    for j, kind in enumerate(cfg.block_pattern):
        if kind in transformer.HEADS_KINDS:
            for leaf, spec in specs[j].items():
                if any(lsh.spec_axes(e) and lsh.spec_axes(e) != batch_axes(mesh) for e in spec):
                    _watch(f"cache.{j}.{leaf}", caches[j][leaf])


def _counts_now() -> np.ndarray:
    from repro_torch.launch import mesh

    counts = mesh.collective_counts()
    return np.asarray([counts[k] for k in sorted(counts)])


def _bytes_now() -> np.ndarray:
    """The collectives' result bytes so far, by kind (``_counts_now``'s order)."""
    from repro_torch.launch import mesh

    sent = mesh.collective_bytes()
    return np.asarray([sent[k] for k in sorted(sent)], dtype=np.int64)


def serve(case, cfg, p, rows=None) -> dict:
    """A prefill of all but the last ``steps + 1`` tokens (``steps`` 1 by
    default), ``steps`` decode steps on the tokens that follow, the
    forward over every token, and each recurrent cache after the last step
    (``cache.<slot>.<leaf>``, stacked over repeats).  Under the rules: the
    caches are this rank's blocks; with ``rows`` (the batch axes' line)
    this rank takes its block of the rows; the first decode step's
    collectives (``decode_collectives``)."""
    from repro_torch.models import sharding, transformer

    batch = inputs(case, cfg)
    whole = batch[0].shape[0]
    if rows is not None:
        b = whole // rows.size
        batch = tuple(x[rows.rank * b:(rows.rank + 1) * b] for x in batch)
    tok, aux = batch[0], (batch[2] if cfg.frontend else None)
    s, steps = tok.shape[1], case.get("steps", 1)
    split = sharding.active() is not None
    kw = {"batch": whole} if split else {}
    start = s - 1 - steps
    logits, caches = transformer.prefill(p, cfg, tok[:, :start], aux, max_seq=s, **kw)
    if split:
        kw["max_seq"] = s
        _watch_states(cfg, caches, sharding.current_mesh(), s, whole)
    out, decoded = {}, []
    for t in range(start, start + steps):
        before, sent = _counts_now(), _bytes_now()
        l_t, caches = transformer.decode_step(p, cfg, tok[:, t:t + 1], caches, t, **kw)
        if split and t == start:
            out["decode_collectives"] = _counts_now() - before
            out["decode_bytes"] = _bytes_now() - sent
        decoded.append(l_t)
    full, _ = transformer.forward(p, cfg, tok, aux)
    for k, x in (("prefill", logits), ("decode", torch.cat(decoded, 1)), ("forward", full)):
        out[k] = _whole_rows(x.detach(), rows).numpy()
    for j, kind in enumerate(cfg.block_pattern):
        if kind in transformer.STATE_KINDS:
            for k, leaf in caches[j].items():
                out[f"cache.{j}.{k}"] = _whole_rows(leaf, rows, 1).numpy()
    return out


def routes(cfg, p, batch) -> dict:
    """Each MoE block's slots and kept pairs (``route.<i>.slot`` and
    ``.keep``, this rank's tokens) in one forward without a gradient."""
    from repro_torch.models import moe, transformer

    got, real = [], moe.route

    def spy(*a, **kw):
        out = real(*a, **kw)
        got.append((out[4].numpy(), out[5].numpy()))
        return out

    moe.route = spy
    try:
        with torch.no_grad():
            transformer.loss_fn(p, cfg, batch)
    finally:
        moe.route = real
    return {f"route.{i}.{n}": x for i, pair in enumerate(got) for n, x in zip(("slot", "keep"), pair)}


def set_aux_coef(case) -> float:
    """Set ``transformer.MOE_AUX_COEF`` for ``case``; returns the old one.
    The a2a's aux is the mean of the shards' local estimates, not the
    whole batch's (the reference's definition): its cases drop the aux
    term and hold the aux against the reference's a2a instead."""
    from repro_torch.models import transformer

    old, transformer.MOE_AUX_COEF = transformer.MOE_AUX_COEF, case.get("aux_coef", 0.01)
    return old


def whole_case(case) -> dict:
    """The case unsplit (no rules): name -> numpy array.  The MoE aux
    coefficient is the case's while it runs and restored after, since the
    parent test process runs other cases (and ``api.run``) after it."""
    from repro_torch.models import transformer

    coef = set_aux_coef(case)
    try:
        return _whole_case(case)
    finally:
        transformer.MOE_AUX_COEF = coef


def _whole_case(case) -> dict:
    from repro_torch.fed.round import RoundSpec, build_round_step
    from repro_torch.models import transformer

    cfg = config(case)
    p = params(case, cfg)
    kind = case["kind"]
    if kind == "loss_grad":
        batch = inputs(case, cfg)
        grads, loss = torch.func.grad_and_value(
            lambda q: transformer.loss_fn(q, cfg, batch))(p)
        out = {"loss": loss.detach().numpy(), **{f"g.{k}": v for k, v in _flat(grads).items()}}
        return {**out, **(routes(cfg, p, batch) if case.get("routes") else {})}
    if kind == "round":
        step = build_round_step(cfg, RoundSpec(cohort=case["cohort"], local_steps=2,
                                               local_batch=2, local_lr=0.05))
        new, norms, loss = step(p, *round_inputs(case, cfg))
        return {"loss": loss.numpy(), "norms": norms.numpy(),
                **{f"p.{k}": v for k, v in _flat(new).items()}}
    if kind == "prefill_decode":
        return serve(case, cfg, p)
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


def dense_against_reference(case) -> dict:
    """The port's dense MoE dispatch on the reference's weights over a
    batch of 3 rows (``case["ref"]``'s ``dense_x``), this rank's block of
    the rows (2 / 1, ``ShardSpec.local_range``) inside ``split_rows``: the
    output of its rows, the aux, and its tokens' slots and kept pairs."""
    from repro_torch.launch.mesh import ShardSpec
    from repro_torch.models import moe, sharding

    ref = np.load(case["ref"])
    cfg = config(case)
    shard = ShardSpec(axes=(("data", 2), ("model", 1)), axis="data")
    x = torch.from_numpy(ref["dense_x"])
    lo, hi = shard.block(x.shape[0])
    p = {k: torch.from_numpy(ref[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    xb = x[lo:hi]
    line = shard.axis_group()
    with sharding.split_rows(line, x.shape[0]):
        out, aux = moe.moe_ffn(p, cfg, xb)
    route = moe.route(p["router"], cfg, xb.reshape(-1, cfg.d_model), (line, x.shape[0] * x.shape[1]))
    return {"out": out.numpy(), "aux": aux.numpy(), "slot": route[4].numpy(),
            "keep": route[5].numpy()}


def rank_case(case) -> dict:
    """The case as this rank's share under ``use_rules`` on its mesh."""
    from repro_torch.fed.round import RoundSpec, build_round_step
    from repro_torch.launch import sharding as lsh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding, transformer

    set_aux_coef(case)  # this process runs one case after another
    if case["kind"] == "a2a_ref":
        return a2a_against_reference(case)
    if case["kind"] == "dense_ref":
        return dense_against_reference(case)
    if case["kind"] == "run":  # api.run on the mesh (its spec's mesh_shape)
        import torch_ranks_worker

        return torch_ranks_worker.run_case(case)
    cfg = config(case)
    mesh = make_mesh(case["mesh"])
    fsdp = bool(case.get("fsdp"))
    whole = params(case, cfg)
    specs = lsh.param_specs(whole, mesh, fsdp)
    p = lsh.param_shardings(whole, mesh, fsdp)
    _watch_params(cfg, p, specs)
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
            out = {"step_collectives": _counts_now(), "step_bytes": _bytes_now()}
            if case.get("routes"):
                out.update(routes(cfg, p, batch))
            grads = lsh.gather_params(grads, specs, mesh)
            return {**out, "loss": loss.detach().numpy(),
                    **{f"g.{k}": v for k, v in _flat(grads).items()}}
        if kind == "round":
            step = build_round_step(cfg, RoundSpec(cohort=case["cohort"], local_steps=2,
                                                   local_batch=2, local_lr=0.05))
            new, norms, loss = step(p, *round_inputs(case, cfg))
            new = lsh.gather_params(new, specs, mesh)
            return {"loss": loss.numpy(), "norms": norms.numpy(),
                    **{f"p.{k}": v for k, v in _flat(new).items()}}
        if kind == "prefill_decode":
            return serve(case, cfg, p, sharding.batch_group() if case.get("rows") else None)
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
    _spy_gathers()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        for case in cases:
            mesh.reset_collective_counts()
            _WATCH.clear(), _GATHERED.clear()
            out = rank_case(case)
            counts = mesh.collective_counts()
            out["collectives"] = np.asarray([counts[k] for k in sorted(counts)])
            out["collective_bytes"] = _bytes_now()
            out["gathered_whole"] = np.asarray(sorted(set(_GATHERED)), dtype=str)
            np.savez(os.path.join(out_dir, f"{case['name']}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
