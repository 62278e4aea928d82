"""The model axis: the port's layouts against the reference's, one rank's
share of the step on gloo CPU ranks against the unsplit step, the a2a MoE
against the reference's, the dry run's count of one chip, and ``api.run``
on meshes with model > 1.

* ``param_specs``, ``cache_shardings`` (over ``input_specs``' caches at
  decode_32k and long_500k) and ``activation_rules`` against
  ``repro.launch.sharding``'s on an ``AbstractMesh``, for every registry
  arch over (16, 16), (2, 16, 16), (2, 2) and (1, 2), fsdp on and off (the
  reference in one subprocess; where it refuses a spec that names an axis
  twice, the port's names it twice too);
* one worker pair (``tests/torch_model_axis_worker.py``, two gloo
  processes) runs every two-rank case, a worker quad the (2, 2) ones: the
  per-rank ``loss_fn`` and its ``torch.func`` gradient gathered whole
  against the unsplit ones at rtol 1e-5, atol 1e-5 (dense with remat full
  and none, the mamba2 hybrid with ``shared_attn``, moe with the dense
  dispatch and with the a2a, whisper, fsdp at (2, 1) on a
  cohort_sequential arch, and the dense dispatch over split rows at a
  capacity that drops pairs, at (2, 1) and (2, 2): slots and kept pairs
  exactly the unsplit step's); one client_parallel round step; prefill, a
  split-cache decode and forward; four decode steps of the mamba2 hybrid
  (at (1, 2), and at (2, 2) over split rows) and of the xLSTM, each rank's
  recurrent state blocks against the unsplit caches'; the mamba2 and mLSTM
  heads computed on a rank's block (the ``state`` rule) in the hybrid and
  xLSTM training, prefill and decode cases, no split weight or state leaf
  of theirs the input of an all_gather, and an xLSTM of 2 heads on a model
  line of 4 (the gathered path; its leaves are seen gathered); ``api.run`` at
  (1, 2) and (1, 1, 2) bitwise the one-rank run, at (2, 2) within the
  S = 2 tolerance, on both stacks, and qwen3's and arctic's
  cohort_sequential rounds at (2, 2) over rows split 2 / 1;
* the port's a2a on the reference's weights against the reference's
  ``_moe_ffn_a2a`` on a two-device CPU mesh (its process started with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=2``): routing, slots
  and capacity drops exact, output and aux at the f32 tolerance; the
  dense dispatch over 3 rows split 2 / 1 against the reference's
  ``moe_ffn`` on the whole batch, slots and drops exact;
* the dry run: a mesh of all ones gives today's record field for field;
  at (1, 2) and (2, 1) the counted collectives of a prefill, a decode step
  and a rows step are the ones the gloo ranks issued; rank 0's parameter
  bytes at (16, 16) are the reference specs' to the byte.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.analysis import cost as cost_mod  # noqa: E402
from repro_torch.configs.registry import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as lsh  # noqa: E402
from repro_torch.launch.mesh import batch_axes, make_mesh  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from test_torch_zoo_round import one_intraop_thread  # noqa: E402, F401

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_model_axis_worker as worker  # noqa: E402
import torch_ranks_worker  # noqa: E402
from test_torch_placement import _task, _zoo, ARCTIC, MOE_TOL, QWEN3, SMOLLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "2x2": (2, 2), "1x2": (1, 2)}
# Rank 0's parameter bytes at (16, 16) (fsdp for the cohort_sequential archs).
TABLE_GB = {"smollm-360m": 0.0453, "zamba2-1.2b": 0.1322, "qwen3-moe-235b-a22b": 1.8502,
            "llama3-405b": 3.1790, "arctic-480b": 3.7342}

SMALL = {"n_layers": 2, "d_model": 64, "d_ff": 128, "vocab": 128}
HYBRID = {"n_layers": 4, "d_model": 64, "d_ff": 128, "vocab": 128,
          "block_pattern": ["mamba2", "mamba2", "mamba2", "shared_attn"]}
MOE = {"n_layers": 2, "d_model": 64, "vocab": 128}
MOE_A2A = {**MOE, "capacity_factor": 4.0}  # no drops: the dense dispatch's rows, exactly
# 4 x 8 tokens, top 2 of 4 experts: a buffer of 8 rows an expert for the
# whole batch drops pairs, and a rank's own 2 rows would give it 4.
MOE_ROWS = {**MOE, "capacity_factor": 0.5}
XLSTM = {"n_layers": 4, "d_model": 64, "vocab": 128}
XLSTM_2H = {**XLSTM, "n_heads": 2}  # a model line of 4 does not divide its heads
DECODE = dict(seq=12, steps=4)  # a prefill of 7 tokens, then 4 decode steps


def _case(name, kind, arch, kwargs, mesh=(1, 2), **kw):
    return {"name": name, "kind": kind, "arch": arch, "kwargs": kwargs, "mesh": list(mesh), **kw}


STEP_CASES = [
    _case("dense_full", "loss_grad", "smollm-360m", SMALL, remat="full"),
    _case("dense_none", "loss_grad", "smollm-360m", SMALL, remat="none"),
    _case("hybrid", "loss_grad", "zamba2-1.2b", HYBRID),
    _case("hybrid_none", "loss_grad", "zamba2-1.2b", HYBRID, remat="none"),
    _case("moe_dense", "loss_grad", "qwen3-moe-235b-a22b", MOE),
    _case("moe_dense_none", "loss_grad", "qwen3-moe-235b-a22b", MOE, remat="none"),
    # The a2a's aux is the shards' mean of local estimates (the reference's):
    # its step drops the aux term; the aux is held to the reference's a2a.
    _case("moe_a2a", "loss_grad", "qwen3-moe-235b-a22b", MOE_A2A, moe_impl="a2a", aux_coef=0.0),
    _case("moe_a2a_none", "loss_grad", "qwen3-moe-235b-a22b", MOE_A2A, moe_impl="a2a",
          aux_coef=0.0, remat="none"),
    _case("whisper", "loss_grad", "whisper-small", SMALL),
    _case("whisper_none", "loss_grad", "whisper-small", SMALL, remat="none"),
    _case("fsdp_rows", "loss_grad", "llama3-405b", SMALL, mesh=(2, 1), fsdp=True, rows=True),
    _case("round", "round", "smollm-360m", SMALL, cohort=3),
    _case("serve", "prefill_decode", "smollm-360m", SMALL),
    _case("serve_whisper", "prefill_decode", "whisper-small", SMALL),  # a split cross cache
    _case("prefill", "prefill", "smollm-360m", SMALL),
    _case("hybrid_decode", "prefill_decode", "zamba2-1.2b", HYBRID, **DECODE),
    _case("xlstm_decode", "prefill_decode", "xlstm-125m", XLSTM, **DECODE),
    # max_seq 3 is the conv state's width: the conv cache stays whole, which
    # the split cell cannot take, so the block takes the gathered path.
    _case("xlstm_decode_conv_whole", "prefill_decode", "xlstm-125m", XLSTM, seq=3, steps=1,
          gathered=True),
    _case("xlstm", "loss_grad", "xlstm-125m", XLSTM),
    _case("xlstm_none", "loss_grad", "xlstm-125m", XLSTM, remat="none"),
    _case("moe_dense_rows", "loss_grad", "qwen3-moe-235b-a22b", MOE_ROWS, mesh=(2, 1),
          rows=True, routes=True),
]
QUAD_STEPS = [  # on the worker quad
    _case("hybrid_decode_rows", "prefill_decode", "zamba2-1.2b", HYBRID, mesh=(2, 2), rows=True,
          **DECODE),
    _case("moe_dense_rows_2x2", "loss_grad", "qwen3-moe-235b-a22b", MOE_ROWS, mesh=(2, 2),
          rows=True, routes=True),
    _case("xlstm_line_over_heads", "loss_grad", "xlstm-125m", XLSTM_2H, mesh=(1, 4),
          gathered=True),
    _case("xlstm_decode_line_over_heads", "prefill_decode", "xlstm-125m", XLSTM_2H, mesh=(1, 4),
          gathered=True, **DECODE),
]
A2A_KW = {"d_model": 32, "vocab": 128, "capacity_factor": 0.5}  # capacity drops on the wire
RUN_SPECS = {"task": _task(), "zoo": _zoo("smollm-360m", SMOLLM, cohort=3, batch_size=2)}


def _with_mesh(d, shape):
    return {**d, "execution": {**d["execution"], "mesh_shape": list(shape)}}


RUN_CASES = [{"name": f"run_{stack}_{'x'.join(map(str, shape))}", "kind": "run",
              "spec": _with_mesh(d, shape)}
             for stack, d in RUN_SPECS.items() for shape in ((1, 2), (1, 1, 2))]
RUN_QUAD = [{"name": f"run_{stack}_2x2", "kind": "run", "spec": _with_mesh(d, (2, 2))}
            for stack, d in RUN_SPECS.items()]
# sampler_axis over both axes: the client axis split over all four ranks.
RUN_QUAD.append({"name": "run_task_2x2_data_model", "kind": "run", "spec": _with_mesh(
    {**RUN_SPECS["task"], "execution": {**RUN_SPECS["task"]["execution"],
                                        "sampler_axis": ["data", "model"]}}, (2, 2))})
# The MoE archs' cohort_sequential rounds: each batch's 3 rows split 2 / 1
# over the data line, replicated over the model line.
RUN_QUAD += [{"name": f"run_{name}_2x2", "kind": "run", "spec": _with_mesh(
    _zoo(arch, kw, cohort=2, batch_size=3), (2, 2))}
    for name, arch, kw in (("qwen3", "qwen3-moe-235b-a22b", QWEN3), ("arctic", "arctic-480b", ARCTIC))]
# Two ranks and no mesh_shape: the host mesh (1, 2).
RUN_CASES.append({"name": "run_zoo_host_mesh", "kind": "run", "spec": RUN_SPECS["zoo"]})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}


def _start(cases, world, tmp):
    path = tmp / f"cases_{world}.json"
    path.write_text(json.dumps(cases))
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_model_axis_worker.py"), str(r), str(world),
         str(port), str(path), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
        for r in range(world)]


def _wait(procs):
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()


_A2A_REF = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.models import moe
    kw = KW_HERE
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(**kw), moe_impl="a2a")
    p = moe.init_moe(cfg, jax.random.PRNGKey(3))
    x = np.random.default_rng(0).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ("data", "model"))
    out, aux = moe._moe_ffn_a2a(p, cfg, jnp.asarray(x), mesh)
    res = dict(x=x, out=np.asarray(out), aux=np.asarray(aux),
               **{k: np.asarray(p[k]) for k in ("router", "w_gate", "w_up", "w_down")})
    # The dense dispatch on the same weights over a whole batch of 3 rows.
    dense = get_config("qwen3-moe-235b-a22b").reduced(**kw)
    x3 = np.random.default_rng(1).standard_normal((3, 8, dense.d_model)).astype(np.float32)
    d_out, d_aux = jax.jit(lambda v: moe.moe_ffn(p, dense, v))(jnp.asarray(x3))
    xf = jnp.asarray(x3.reshape(-1, dense.d_model))
    _, top_idx = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], axis=-1), dense.top_k)
    mask = jnp.sum(jax.nn.one_hot(top_idx, dense.n_experts, dtype=jnp.float32), axis=1)
    position = jnp.cumsum(mask, axis=0) * mask - 1.0
    slot = jnp.take_along_axis(position, top_idx, axis=1).astype(jnp.int32)
    cap = int(max(1, round(dense.capacity_factor * xf.shape[0] * dense.top_k / dense.n_experts)))
    res.update(dense_x=x3, dense_out=np.asarray(d_out), dense_aux=np.asarray(d_aux),
               dense_slot=np.asarray(slot), dense_keep=np.asarray((slot >= 0) & (slot < cap)))
    e_loc, k = cfg.n_experts // 2, cfg.top_k
    for r in range(2):
        xf = jnp.asarray(x[:, r * 4:(r + 1) * 4].reshape(-1, cfg.d_model))
        gates = jax.nn.softmax(xf @ p["router"], axis=-1)
        _, top_idx = jax.lax.top_k(gates, k)
        t = xf.shape[0]
        cap_pair = int(max(8, round(cfg.capacity_factor * t * k / 2)))
        _, slot, kept = moe._pack_by_dest(jnp.repeat(xf, k, axis=0), top_idx.reshape(-1) // e_loc,
                                          2, cap_pair)
        res[f"top_idx{r}"], res[f"slot{r}"] = np.asarray(top_idx), np.asarray(slot)
        res[f"kept{r}"], res["cap_pair"] = np.asarray(kept), np.asarray(cap_pair)
    np.savez(sys.argv[1], **res)
    """
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the pair (and the (2, 2) runs on the quad), with the
    reference's a2a written first: name -> [each rank's npz]."""
    tmp = tmp_path_factory.mktemp("model_axis")
    ref = tmp / "a2a_ref.npz"
    proc = subprocess.run([sys.executable, "-c", _A2A_REF.replace("KW_HERE", repr(A2A_KW)), str(ref)],
                          capture_output=True, text=True, timeout=300,
                          env={**_env(), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    a2a = _case("a2a_ref", "a2a_ref", "qwen3-moe-235b-a22b", A2A_KW, moe_impl="a2a",
                ref=str(ref))
    dense = _case("dense_ref", "dense_ref", "qwen3-moe-235b-a22b", A2A_KW, mesh=(2, 1),
                  ref=str(ref))
    pair_cases = STEP_CASES + [a2a, dense] + RUN_CASES
    quad_cases = QUAD_STEPS + RUN_QUAD
    pair, quad = _start(pair_cases, 2, tmp), _start(quad_cases, 4, tmp)
    _wait(pair + quad)
    out = {c["name"]: [dict(np.load(tmp / f"{c['name']}_r{r}.npz")) for r in range(2)]
           for c in pair_cases}
    out.update({c["name"]: [dict(np.load(tmp / f"{c['name']}_r{r}.npz")) for r in range(4)]
                for c in quad_cases})
    out["a2a_ref"].append(dict(np.load(ref)))
    out["dense_ref"].append(out["a2a_ref"][-1])
    return out


# -- the layouts against the reference's ------------------------------------------

_SPECS_REF = textwrap.dedent(
    """
    import json
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from repro.configs import get_config, list_archs, INPUT_SHAPES, input_specs, step_kind
    from repro.configs.llama3_2_1b import SW_CONFIG
    from repro.launch import sharding as rs
    from repro.models import transformer

    def key(path):
        return ".".join(str(e.key) if hasattr(e, "key") else str(e.idx) for e in path)

    def entry(e):
        return e if e is None or isinstance(e, str) else list(e)

    def flat(specs, tree):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
        return {key(path): [entry(e) for e in s] + [None] * (len(leaf.shape) - len(s))
                for (path, leaf), s in zip(leaves, sp)}

    meshes = MESHES_HERE
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}
    res = {"params": {}, "caches": {}, "rules": {}}
    for arch in list_archs():
        cfg = get_config(arch)
        params = jax.eval_shape(lambda: transformer.init_params(cfg, jax.random.PRNGKey(0)))
        for mname, sizes in meshes.items():
            mesh = AbstractMesh(tuple(sizes), names[len(sizes)])
            for fsdp in (False, True):
                res["params"][f"{arch}|{mname}|{fsdp}"] = flat(
                    rs.param_specs(params, mesh, fsdp), params)
            for shape_name in ("decode_32k", "long_500k"):
                c = SW_CONFIG if (arch == "llama3.2-1b" and shape_name == "long_500k") else cfg
                sh = INPUT_SHAPES[shape_name]
                if step_kind(c, sh) is None:
                    continue
                caches = input_specs(c, sh)["caches"]
                try:
                    cs = rs.cache_shardings(caches, mesh, sh.seq_len, sh.global_batch)
                except Exception as e:  # a spec naming an axis twice
                    res["caches"][f"{arch}|{mname}|{shape_name}"] = type(e).__name__
                    continue
                specs = jax.tree_util.tree_map(lambda s: s.spec, cs)
                res["caches"][f"{arch}|{mname}|{shape_name}"] = flat(specs, caches)
    for mname, sizes in meshes.items():
        mesh = AbstractMesh(tuple(sizes), names[len(sizes)])
        for lc in (False, True):
            for cp in (False, True):
                r = rs.activation_rules(mesh, long_context=lc, client_parallel=cp)
                res["rules"][f"{mname}|{lc}|{cp}"] = {k: entry(v) for k, v in r.items()}
    print("RESULT", json.dumps(res))
    """
)


@pytest.fixture(scope="module")
def ref_specs():
    proc = subprocess.run([sys.executable, "-c", _SPECS_REF.replace("MESHES_HERE", repr(MESHES))],
                          capture_output=True, text=True, timeout=300,
                          env={**_env(), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("RESULT", 1)[1])


def _flat_specs(specs, prefix=""):
    if isinstance(specs, dict):
        out = {}
        for k in sorted(specs):
            out.update(_flat_specs(specs[k], f"{prefix}{k}."))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_flat_specs(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: [_canon(e) for e in specs]}


def _canon(e):
    """A spec entry as JSON, a one-axis tuple as its name (the reference's
    ``PartitionSpec`` gives ('data',) as 'data')."""
    if e is None or isinstance(e, str):
        return e
    e = list(e)
    return e[0] if len(e) == 1 else e


def _canon_tree(flat: dict) -> dict:
    return {k: [_canon(e) for e in v] for k, v in flat.items()}


def _cfg(arch, shape_name):
    if arch == "llama3.2-1b" and shape_name == "long_500k":
        return configs.get_config("llama3.2-1b-sw")
    return configs.get_config(arch)


@pytest.mark.parametrize("mname", list(MESHES))
def test_param_specs_match_reference(ref_specs, mname):
    mesh = make_mesh(MESHES[mname])
    for arch in configs.list_archs():
        tree = transformer.init_params(configs.get_config(arch), None, "meta")
        for fsdp in (False, True):
            want = _canon_tree(ref_specs["params"][f"{arch}|{mname}|{fsdp}"])
            assert _flat_specs(lsh.param_specs(tree, mesh, fsdp)) == want, (arch, fsdp)


@pytest.mark.parametrize("mname", list(MESHES))
def test_cache_shardings_and_rules_match_reference(ref_specs, mname):
    mesh = make_mesh(MESHES[mname])
    n = 0
    for arch in configs.list_archs():
        for shape_name in ("decode_32k", "long_500k"):
            cfg, sh = _cfg(arch, shape_name), configs.INPUT_SHAPES[shape_name]
            if configs.step_kind(cfg, sh) is None:
                continue
            caches = configs.input_specs(cfg, sh)["caches"]
            got = _flat_specs(lsh.cache_shardings(caches, mesh, sh.seq_len, sh.global_batch))
            want = ref_specs["caches"][f"{arch}|{mname}|{shape_name}"]
            if isinstance(want, str):  # the reference refuses an axis named twice
                assert any(len(sum(([e] if isinstance(e, str) else e for e in s if e), []))
                           != len(set(sum(([e] if isinstance(e, str) else e for e in s if e),
                                          []))) for s in got.values()), (arch, shape_name)
            else:
                assert got == _canon_tree(want), (arch, shape_name)
            n += 1
    assert n >= 10
    for lc in (False, True):
        for cp in (False, True):
            got = {k: _canon(v) for k, v in lsh.activation_rules(
                mesh, long_context=lc, client_parallel=cp).items()}
            assert got == {k: _canon(v) for k, v in ref_specs["rules"][f"{mname}|{lc}|{cp}"].items()}


def _rank0_bytes(specs: dict, tree, mesh) -> int:
    total = 0
    for name, leaf in _named(tree):
        parts = 1
        for e in specs[name]:
            for a in ([e] if isinstance(e, str) else (e or [])):
                parts *= mesh.shape[a]
        total += leaf.numel() * leaf.element_size() // parts
    return total


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_rank0_parameter_bytes_match_reference(ref_specs):
    """Rank 0's blocks (``param_shardings`` on ``meta``) at (16, 16) hold
    the bytes the reference's specs give, to the byte, and the table."""
    mesh = make_mesh((16, 16))
    for arch, gb in TABLE_GB.items():
        cfg = configs.get_config(arch)
        fsdp = cfg.round_mode == "cohort_sequential"
        tree = transformer.init_params(cfg, None, "meta")
        blocks = lsh.param_shardings(tree, mesh, fsdp, rank=0)
        got = sum(t.numel() * t.element_size() for _, t in _named(blocks))
        want = _rank0_bytes(ref_specs["params"][f"{arch}|16x16|{fsdp}"], tree, mesh)
        assert got == want and round(got / 1e9, 4) == gb, (arch, got, want)


def test_blocks_assemble_back():
    """``assemble`` is ``param_shardings``' inverse over every rank."""
    cfg = configs.get_config("qwen3-moe-235b-a22b").reduced(**MOE)
    whole = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for shape, fsdp in (((2, 2), True), ((1, 2), False), ((2, 1, 2), True)):
        mesh = make_mesh(shape)
        per_rank = [lsh.param_shardings(whole, mesh, fsdp, rank=r) for r in range(mesh.size)]
        back = lsh.assemble(per_rank, lsh.param_specs(whole, mesh, fsdp), mesh)
        for (k, a), (_, b) in zip(_named(whole), _named(back)):
            assert torch.equal(a, b), (shape, k)


def test_shard_checks_the_split_dims():
    """``shard`` returns its input; under the rules it checks each split
    dimension's local size and raises on a mismatch."""
    x = torch.zeros(2, 3, 8)
    assert msh.shard(x, "batch", "seq", "ffn", whole=(None, None, 16)) is x
    with msh.use_rules(make_mesh((1, 2))):
        assert msh.shard(x, "batch", "seq", "ffn", whole=(None, None, 16)) is x
        with pytest.raises(ValueError, match="the rules imply 8 of 16"):
            msh.shard(torch.zeros(2, 3, 16), "batch", "seq", "ffn", whole=(None, None, 16))
        with pytest.raises(ValueError, match="logical axes"):
            msh.shard(x, "batch", "ffn")


# -- one rank's share against the unsplit step ------------------------------------


def _held(got: dict, want: dict, name: str) -> None:
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=f"{name} {k}", **TOL)


def _held_blocks(case, got: list, caches: dict) -> None:
    """Each rank's recurrent cache leaves (its rows gathered whole) against
    its block of the unsplit caches under ``cache_shardings``; some leaf is
    split."""
    cfg, mesh = worker.config(case), make_mesh(case["mesh"])
    b, s = case.get("batch", 4), case["seq"]
    specs = lsh.cache_shardings(transformer.init_caches(cfg, b, s, device="meta"), mesh, s, b)
    split = 0
    for k, w in caches.items():
        _, j, leaf = k.split(".")
        spec = tuple(None if i == 1 and lsh.spec_axes(e) == batch_axes(mesh) else e
                     for i, e in enumerate(specs[int(j)][leaf]))
        for r, rr in enumerate(got):
            block = lsh.block_of(torch.from_numpy(w), spec, mesh, rank=r).numpy()
            np.testing.assert_allclose(rr[k], block, err_msg=f"{k} rank {r}", **TOL)
            split += rr[k].size < w.size
    assert split


def _held_routes(case, got: list, routes: dict) -> None:
    """Each MoE block's slots and kept pairs: the ranks of one data line's
    block agree, and the data blocks' tokens in row order are the unsplit
    step's, drops included."""
    mesh = make_mesh(case["mesh"])
    blocks: dict = {}
    for r, rr in enumerate(got):
        blocks.setdefault(mesh.coords(r)["data"], []).append(rr)
    for k, w in routes.items():
        for same in blocks.values():
            for rr in same[1:]:
                np.testing.assert_array_equal(rr[k], same[0][k], err_msg=k)
        whole = np.concatenate([blocks[d][0][k] for d in sorted(blocks)])
        np.testing.assert_array_equal(whole, w, err_msg=k)
    assert not all(w.all() for k, w in routes.items() if k.endswith(".keep"))


def _heads_split(case):
    """Whether the case's mamba2/mlstm blocks compute their heads split
    (None: it has none): all but the ``gathered`` cases, whose line does
    not divide the heads or whose caches the split cell cannot take."""
    if not set(worker.config(case).block_pattern) & set(transformer.HEADS_KINDS):
        return None
    return not case.get("gathered")


@pytest.mark.parametrize("case", STEP_CASES + QUAD_STEPS,
                         ids=[c["name"] for c in STEP_CASES + QUAD_STEPS])
def test_rank_step_holds_unsplit(case, ranks, one_intraop_thread):  # noqa: F811
    """Every rank's loss, gathered gradients (or round params, norms and
    loss; or logits) equal the unsplit step's; the ranks agree bitwise.  A
    decode case's recurrent state blocks equal the unsplit caches' blocks;
    a rows case's slots and kept pairs are the unsplit step's exactly.  A
    case whose mamba2/mlstm heads the model line divides gathers none of
    their split weight or state leaves (a prefill moves the heads' states
    to the caches' layout by all_to_all); one whose line does not divide
    them gathers its leaves whole, and the check sees it."""
    want = worker.whole_case(case)
    got = ranks[case["name"]]
    caches = {k: want.pop(k) for k in list(want) if k.startswith("cache.")}
    routes = {k: want.pop(k) for k in list(want) if k.startswith("route.")}
    r0 = got[0]
    _held(r0, want, case["name"])
    for rr in got[1:]:
        for k in want:
            np.testing.assert_array_equal(rr[k], r0[k], err_msg=k)
    if caches:
        _held_blocks(case, got, caches)
    if routes:
        _held_routes(case, got, routes)
    kinds = dict(zip(sorted(["all_reduce", "all_gather", "broadcast", "reduce_scatter",
                             "all_to_all"]), r0["collectives"]))
    assert kinds["all_reduce"] > 0 or kinds["reduce_scatter"] > 0
    if case.get("moe_impl") == "a2a":
        assert kinds["all_to_all"] > 0
    if case.get("fsdp"):
        assert kinds["reduce_scatter"] > 0  # the fsdp gather's backward
    split = _heads_split(case)
    for r, rr in enumerate(got):
        gathered = rr["gathered_whole"].tolist()
        if split:
            assert not gathered, f"rank {r} gathered {gathered} whole"
        elif split is not None:
            assert gathered, f"rank {r}: the gathered path's leaves are not seen"
    if split and case["kind"] == "prefill_decode":
        assert kinds["all_to_all"] > 0


def test_a2a_matches_reference(ranks):
    """The port's ``_moe_ffn_a2a`` on two gloo ranks against the
    reference's on its two-device mesh: the same top-k experts, slots and
    kept rows on each rank's token slice (drops included), the output and
    aux at the f32 tolerance."""
    r0, r1, ref = ranks["a2a_ref"]
    assert int(r0["cap_pair"]) == int(ref["cap_pair"])
    dropped = 0
    for r, got in enumerate((r0, r1)):
        np.testing.assert_array_equal(got["top_idx"], ref[f"top_idx{r}"])
        np.testing.assert_array_equal(got["slot"], ref[f"slot{r}"])
        np.testing.assert_array_equal(got["kept"], ref[f"kept{r}"])
        dropped += int((~got["kept"]).sum())
        np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-5, atol=1e-6)
    assert dropped > 0  # the case exercises the capacity drops


def test_dense_rows_match_reference(ranks):
    """The dense dispatch over a batch of 3 rows split 2 / 1 over two ranks
    (``split_rows``) against the reference's ``moe_ffn`` on the whole
    batch (jitted, CPU, the same weights): the ranks' outputs in row order
    and each rank's aux at the f32 tolerance; the slots and kept pairs
    exactly, with drops at the whole batch's capacity."""
    r0, r1, ref = ranks["dense_ref"]
    assert r0["out"].shape[0] == 2 and r1["out"].shape[0] == 1
    np.testing.assert_allclose(np.concatenate([r0["out"], r1["out"]]), ref["dense_out"], **TOL)
    for rr in (r0, r1):
        np.testing.assert_allclose(rr["aux"], ref["dense_aux"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.concatenate([r0["slot"], r1["slot"]]), ref["dense_slot"])
    np.testing.assert_array_equal(np.concatenate([r0["keep"], r1["keep"]]), ref["dense_keep"])
    assert not ref["dense_keep"].all()


@pytest.mark.parametrize("case", RUN_CASES + RUN_QUAD, ids=[c["name"] for c in RUN_CASES + RUN_QUAD])
def test_api_run_replicates_over_model(case, ranks, one_intraop_thread):  # noqa: F811
    """``api.run`` on a mesh with model > 1 (and on two ranks with no
    mesh_shape: the host mesh (1, 2)): every rank returns the one-rank
    run's history, bitwise where the data axes hold one rank, and within
    the S = 2 tolerance where they hold two ((2, 2); the MoE rounds' own,
    ``test_torch_placement.MOE_TOL``)."""
    execution = {k: v for k, v in case["spec"]["execution"].items() if k != "mesh_shape"}
    want = torch_ranks_worker.run_case({**case, "spec": {**case["spec"],
                                                         "execution": execution}})
    got = ranks[case["name"]]
    for r in got:
        for k, w in want.items():
            if "2x2" in case["name"]:
                scale = max(1e-30, float(np.max(np.abs(w)))) if w.size else 1.0
                tol = MOE_TOL if case["name"].startswith(("run_qwen3", "run_arctic")) else 1e-6
                np.testing.assert_allclose(r[k], w, rtol=0, atol=tol * scale, err_msg=k)
            else:
                np.testing.assert_array_equal(r[k], w, err_msg=k)
    for r in got[1:]:
        for k in want:
            np.testing.assert_array_equal(r[k], got[0][k], err_msg=k)


def test_two_ranks_default_to_the_model_axis(monkeypatch):
    """Two ranks and no mesh_shape give the host mesh (1, 2)."""
    from repro_torch.launch import mesh

    monkeypatch.delenv("REPRO_MESH_SHAPE", raising=False)
    assert mesh.make_host_mesh(world=2).shape == {"data": 1, "model": 2}


# -- the dry run's count of one chip ---------------------------------------------

TINY = {"train_4k": InputShape("train_4k", 32, 64, "train"),
        "prefill_32k": InputShape("prefill_32k", 32, 4, "prefill"),
        "decode_32k": InputShape("decode_32k", 32, 4, "decode"),
        "long_500k": InputShape("long_500k", 64, 1, "decode")}


@pytest.mark.parametrize("shape", list(TINY))
def test_dryrun_mesh_of_ones_is_today(shape, monkeypatch):
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", TINY)
    monkeypatch.setattr(dryrun, "_cfg_for",
                        lambda a, s: configs.get_config(a).reduced(**SMALL))
    a = dryrun.run_one("smollm-360m", shape)
    b = dryrun.run_one("smollm-360m", shape, mesh_shape=(1, 1))
    a.pop("trace_s", None), b.pop("trace_s", None)
    assert a == b


@pytest.mark.parametrize("arch,shape,mesh", [
    ("smollm-360m", "train_4k", (2, 2)), ("smollm-360m", "decode_32k", (1, 2)),
    ("qwen3-moe-235b-a22b", "train_4k", (2, 2)), ("zamba2-1.2b", "prefill_32k", (2, 2)),
    ("llama3.2-1b-sw", "long_500k", (2, 2)), ("zamba2-1.2b", "decode_32k", (2, 2)),
    ("xlstm-125m", "long_500k", (1, 2))])
def test_dryrun_counts_one_chip(arch, shape, mesh, monkeypatch):
    """A reduced step counted as rank 0 of a mesh: n_chips and the mesh
    column, collectives charged, rank 0's parameter blocks; the report
    prints the mesh."""
    from repro_torch.analysis import report

    kw = {"smollm-360m": SMALL, "qwen3-moe-235b-a22b": MOE, "zamba2-1.2b": HYBRID,
          "llama3.2-1b-sw": SMALL, "xlstm-125m": XLSTM}[arch]
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", TINY)
    monkeypatch.setattr(dryrun, "_cfg_for", lambda a, s: configs.get_config(a).reduced(**kw))
    r = dryrun.run_one(arch, shape, mesh_shape=mesh)
    name = "x".join(map(str, mesh))
    assert r["status"] == "ok" and r["n_chips"] == int(np.prod(mesh)) and r["mesh"] == name
    assert r["collective_bytes"] > 0 and r["collectives"]
    cfg = configs.get_config(arch).reduced(**kw)
    tree = transformer.init_params(cfg, None, "meta")
    fsdp = cfg.round_mode == "cohort_sequential"
    m = make_mesh(mesh)
    assert r["param_bytes"] == _rank0_bytes(_flat_specs(lsh.param_specs(tree, m, fsdp)), tree, m)
    assert f"| {arch} | {shape} | {name} | ok |" in report.dryrun_table([r])
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("name", ["prefill", "hybrid_decode", "xlstm_decode", "moe_dense_rows",
                                  "xlstm"])
def test_dryrun_collectives_equal_the_ranks(name, ranks):
    """Rank 0's count of a reduced step charges the collectives the gloo
    ranks issued, kind for kind, and the bytes rank 0's calls returned
    (``launch.mesh.collective_bytes``): the prefill at (1, 2), one decode step
    over recurrent caches split over ``model`` (the heads' projections
    gathered, the state blocks' partial sums reduced), the MoE loss and
    gradient over rows split at (2, 1) (each block's count gather and
    sums' all_reduce), and the xLSTM's loss and gradient at (1, 2) on
    split mLSTM heads."""
    from repro_torch.launch.dryrun import _cut

    case = next(c for c in STEP_CASES if c["name"] == name)
    cfg = worker.config(case)
    m = cost_mod.CountingMesh(("data", "model"), tuple(case["mesh"]))
    blocks = lsh.param_shardings(transformer.init_params(cfg, None, "meta"), m, False, rank=0)
    batch = worker.inputs(case, cfg)
    b, s = batch[0].shape
    rules = lsh.activation_rules(m)
    if not case.get("rows"):
        rules["batch"] = None
    r0 = ranks[name][0]
    with msh.use_rules(m, rules):
        if case["kind"] == "prefill":
            c, _ = cost_mod.count(lambda p, t: transformer.prefill(p, cfg, t), blocks, batch[0])
            issued, sent = r0["collectives"], r0["collective_bytes"]
        elif case["kind"] == "prefill_decode":
            caches = transformer.init_caches(cfg, b, s, device="meta")
            specs = lsh.cache_shardings(caches, m, s, b)
            caches = [_cut(x, sp, m) for x, sp in zip(caches, specs)]
            t = s - 1 - case["steps"]
            c, _ = cost_mod.count(lambda p, tok, cc: transformer.decode_step(
                p, cfg, tok, cc, t, max_seq=s, batch=b), blocks, batch[0][:, t:t + 1], caches)
            issued, sent = r0["decode_collectives"], r0["decode_bytes"]
        else:
            rows = b // m.shape["data"]
            c, _ = cost_mod.count(lambda p, x, y: torch.func.grad_and_value(
                lambda q: transformer.loss_fn(q, cfg, (x, y)))(p), blocks, batch[0][:rows],
                batch[1][:rows])
            issued, sent = r0["step_collectives"], r0["step_bytes"]
    issued = dict(zip(sorted(["all_reduce", "all_gather", "broadcast", "reduce_scatter",
                              "all_to_all"]), issued.tolist()))
    issued = {k.replace("_", "-"): v for k, v in issued.items() if v}
    assert c.collectives == issued
    assert c.collective_bytes == int(sent.sum()) > 0


def test_recomputed_group_keeps_the_rules_on_another_thread():
    """A CUDA backward runs on the autograd engine's device thread, which
    does not inherit the caller's context: a group recomputed there (remat
    "full") must still run as this rank's share.  Here the backward runs on
    a thread of its own, over a ``fake`` group of two ranks (collectives
    that move nothing: the shapes are what is checked)."""
    import threading

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = configs.get_config("smollm-360m").reduced(**SMALL)
    assert cfg.remat == "full"
    mesh = make_mesh((1, 2))
    whole = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        blocks = lsh.param_shardings(whole, mesh, False)
        leaves = list(_named(blocks))
        for _, t in leaves:
            t.requires_grad_(True)
        rules = lsh.activation_rules(mesh)
        rules["batch"] = None
        with msh.use_rules(mesh, rules):
            loss = transformer.loss_fn(blocks, cfg, (tok, tok))
        errors = []

        def backward():
            try:
                loss.backward()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and not errors, errors
        for name, leaf in leaves:
            assert leaf.grad is not None and leaf.grad.shape == leaf.shape, name
    finally:
        dist.destroy_process_group()
