"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``analysis/{cost,roofline,report}.py``, ``configs.step_kind`` /
``input_specs``) against the JAX reference on the CPU.

* ``step_kind`` and ``input_specs``: the same shapes, dtypes and skips as
  the reference's for every registered arch x ``INPUT_SHAPES`` entry;
* ``active_params`` equals the reference's over ``jax.eval_shape`` of its
  ``init_params`` for every arch; ``model_flops`` and ``roofline`` give the
  reference's numbers from the same inputs and the same peaks;
* ``roofline_table``, ``dryrun_table`` and ``perf_table`` print the
  reference's strings from one list of records, apart from the mesh
  (``1xH100``) and the last column (``trace s``);
* ``count`` on closed forms: a toy function's bytes, peak and operations
  exactly; the matmul class of a reduced dense prefill exactly 2 x tokens x
  its matmul parameters plus kernel 7's 4 x pairs x hd x heads; kernels 6-8
  on ``meta`` tensors charged their formulas, their plain versions never
  run; kernel 7's PyTorch backward counted op by op;
* ``run_one`` for reduced configs in each kind, and a frontend arch's round
  step, without initialising CUDA; the multi-rank refusals.
"""
import dataclasses
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.configs.llama3_2_1b import SW_CONFIG as REF_SW_CONFIG  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import cost, report  # noqa: E402
from repro_torch.configs.registry import InputShape  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

# Both packages' ``analysis`` export the function ``roofline`` under the
# module's name.
ref_roofline = importlib.import_module("repro.analysis.roofline")
roofline = importlib.import_module("repro_torch.analysis.roofline")
ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.list_archs()
# The reference's HW with the port's peaks: the same numbers into both.
REF_HW = ref_roofline.HW(peak_flops=roofline.HW.peak_flops, hbm_bw=roofline.HW.hbm_bw,
                         ici_bw=roofline.HW.link_bw)


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _leaves(tree, path=""):
    """(path, shape, dtype) of every leaf, dict keys sorted (jax's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tuple(int(s) for s in tree.shape), _dtype(tree.dtype))]


def test_registry_and_shapes_match_reference():
    assert ARCHS == ref_configs.list_archs()
    assert {k: dataclasses.astuple(v) for k, v in configs.INPUT_SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_configs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_step_kind_and_input_specs_match_reference(arch):
    """Every shape's step and its inputs; decode's index is a host int in
    the port (``decode_step`` takes the position on the host), an int32
    scalar in the reference."""
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name, shape in configs.INPUT_SHAPES.items():
        ref_shape = ref_configs.INPUT_SHAPES[name]
        kind = configs.step_kind(cfg, shape)
        assert kind == ref_configs.step_kind(ref_cfg, ref_shape)
        if kind is None:
            with pytest.raises(ValueError, match="skips"):
                configs.input_specs(cfg, shape)
            continue
        got, want = configs.input_specs(cfg, shape), ref_configs.input_specs(ref_cfg, ref_shape)
        assert sorted(got) == sorted(want)
        if kind == "decode":
            assert isinstance(got.pop("index"), int)
            index = want.pop("index")
            assert index.shape == () and _dtype(index.dtype) == "int32"
        assert _leaves(got) == _leaves(want)
        assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_long_context_configs_match_reference():
    """long_500k: the skips, and llama3.2-1b's sliding-window sibling."""
    shape = configs.INPUT_SHAPES["long_500k"]
    for arch in ARCHS:
        cfg = dryrun._cfg_for(arch, "long_500k")
        want = REF_SW_CONFIG if arch == "llama3.2-1b" else ref_configs.get_config(arch)
        assert cfg.name == want.name and cfg.long_context_ok == want.long_context_ok
        assert configs.step_kind(cfg, shape) == ref_configs.step_kind(
            want, ref_configs.INPUT_SHAPES["long_500k"])
    assert configs.step_kind(dryrun._cfg_for("llama3.2-1b", "long_500k"), shape) == "decode"


@pytest.mark.parametrize("arch", ARCHS + ["llama3.2-1b-sw"])
def test_active_params_match_reference(arch):
    cfg = configs.get_config(arch)
    ref_cfg = REF_SW_CONFIG if arch == "llama3.2-1b-sw" else ref_configs.get_config(arch)
    shapes = jax.eval_shape(lambda: ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    want = ref_roofline.active_params(ref_cfg, shapes)
    got = roofline.active_params(cfg, transformer.init_params(cfg, None, "meta"))
    assert got == want > 0


def test_model_flops_and_roofline_match_reference():
    for kind in ("train", "prefill", "decode"):
        assert roofline.model_flops(3.5e8, 4096.0, kind) == ref_roofline.model_flops(
            3.5e8, 4096.0, kind)
    for args in ((2.1e15, 3.3e12, 0.0, 1, 1.2e15), (7.0e9, 4.4e11, 1.0e9, 1, 0.0),
                 (0.0, 1.0, 0.0, 1, 5.0)):
        got = roofline.roofline(*args).as_dict()
        assert got == ref_roofline.roofline(*args, hw=REF_HW).as_dict()
    hw = roofline.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.tf32_flops, hw.f32_flops, hw.link_bw) == (
        989e12, 3.35e12, 495e12, 67e12, 450e9)


def _records() -> list:
    """Records of every status, with both packages' last-column key."""
    ok = dict(multi_pod=False, status="ok", n_chips=1, collective_bytes=0.0, compile_s=12.5,
              trace_s=12.5, opts=[])
    return [
        {**ok, "arch": "smollm-360m", "shape": "train_4k", "kind": "train",
         "round_mode": "client_parallel", "flops": 2.345e15, "bytes_accessed": 4.1e12,
         "model_flops": 2.2e15, "memory": {"argument_size_bytes": 723517440,
                                           "temp_size_bytes": 61234567890}},
        {**ok, "arch": "gemma2-27b", "shape": "prefill_32k", "kind": "prefill",
         "round_mode": "cohort_sequential", "flops": 3.1e16, "bytes_accessed": 9.9e11,
         "model_flops": 1.7e16, "memory": {"argument_size_bytes": 5.4e10, "temp_size_bytes": 77}},
        {**ok, "arch": "xlstm-125m", "shape": "decode_32k", "kind": "decode",
         "round_mode": "client_parallel", "flops": 3.6e10, "bytes_accessed": 1.9e10,
         "collective_bytes": 1023.0, "model_flops": 3.4e10, "trace_s": 3.3, "compile_s": 3.3,
         "memory": {"argument_size_bytes": 2108976320, "temp_size_bytes": 912077576}},
        {"arch": "smollm-360m", "shape": "long_500k", "multi_pod": False, "status": "skip",
         "reason": "full-attention arch skips long_500k (DESIGN.md section 4)"},
        {"arch": "arctic-480b", "shape": "train_4k", "multi_pod": False, "status": "timeout"},
    ]


def test_tables_match_reference(tmp_path):
    """The reference's strings from one list of records, but for the mesh
    and the last column."""
    results = _records()
    assert report.roofline_table(results) == ref_report.roofline_table(results, REF_HW)
    want = ref_report.dryrun_table(results).replace("| 16x16 |", "| 1xH100 |").replace(
        "| compile s |", "| trace s |")
    assert report.dryrun_table(results) == want
    assert report.summarize(results) == ref_report.summarize(results)
    for i, r in enumerate(results):
        (tmp_path / f"v{i}.json").write_text(json.dumps({**r, "opts": ["remat_none"][: i % 2]}))
    (tmp_path / "empty.json").write_text("")
    assert report.perf_table(str(tmp_path)) == ref_report.perf_table(str(tmp_path), REF_HW)


def test_count_toy_exactly():
    """A toy of known traffic and peak: x (1024,) f32 read by a multiply
    (y), y by an add (z) with y still alive, then y freed, z viewed and
    added to in place, the view summed.  Views move nothing; the in-place
    add reads and writes z's storage and adds none."""

    def f(x):
        y = x * 2.0
        z = y + 1
        del y
        w = z.view(32, 32)
        w.add_(1)
        return w.sum()

    c, out = cost.count(f, torch.empty(1024, device="meta"))
    n = 1024 * 4
    assert c.bytes_accessed == 3 * (n + n) + n + 4
    assert (c.flops, c.pointwise_flops, c.reduction_flops, c.matmul_flops) == (4096, 3072, 1024, 0)
    assert c.memory == {"argument_size_bytes": n, "output_size_bytes": 4,
                        "temp_size_bytes": 2 * n, "generated_code_size_bytes": 0}
    assert c.ops == {"mul": 1, "add": 1, "view": 1, "add_": 1, "sum": 1}
    assert tuple(out.shape) == () and not torch.cuda.is_initialized()


SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)


def test_count_dense_prefill_matmul_class_exactly():
    """Reduced smollm prefill, B=2, S=16: the matmuls are each layer's
    projections and MLP over every token and the tied head over the last
    token, 2 FLOPs a multiply-add; kernel 7 adds 4 hd per unmasked (query,
    key) pair for every query head."""
    cfg = configs.get_config("smollm-360m").reduced(**SMALL)
    params = transformer.init_params(cfg, None, "meta")
    b, s = 2, 16
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    c, _ = cost.count(lambda p, t: transformer.prefill(p, cfg, t), params, tok)
    layer = sum(t.numel() for stack in params["stacks"] for t in jax.tree_util.tree_leaves(
        stack, is_leaf=lambda x: isinstance(x, torch.Tensor)) if t.dim() == 3)
    head = params.get("lm_head", params["embed"]).numel()
    attn = 4 * fa.attention_pairs(s, s, True, None) * cfg.hd * cfg.n_heads * b * cfg.n_layers
    assert c.matmul_flops == 2 * b * s * layer + 2 * b * head + attn
    assert c.kernels["flash_attention"] == {"calls": cfg.n_layers, "flops": attn,
                                            "bytes": cfg.n_layers * fa.work(
                                                torch.empty(b, cfg.n_heads, s, cfg.hd),
                                                torch.empty(b, cfg.n_kv_heads, s, cfg.hd),
                                                True, None)[1]}
    assert c.kernels["rmsnorm"]["calls"] == 2 * cfg.n_layers + 1


def _kernel_calls(x, scale, q, k, v, xs, da, bm, cm):
    return (rms.rmsnorm(x, scale), fa.flash_attention(q, k, v, causal=True, q_groups=2),
            ssd.ssd_scan(xs, da, bm, cm, chunk=8, return_state=True))


def _kernel_inputs():
    m = dict(device="meta")
    return (torch.empty(10, 48, dtype=torch.bfloat16, **m), torch.empty(48, dtype=torch.bfloat16, **m),
            torch.empty(2, 4, 24, 32, dtype=torch.bfloat16, **m),
            torch.empty(2, 2, 24, 32, dtype=torch.bfloat16, **m),
            torch.empty(2, 2, 24, 32, dtype=torch.bfloat16, **m),
            torch.empty(6, 20, 16, **m), torch.empty(6, 20, **m), torch.empty(3, 20, 8, **m),
            torch.empty(3, 20, 8, **m))


def test_kernels_are_charged_their_formulas(monkeypatch):
    """Kernels 6-8 on ``meta`` tensors allocate their outputs and are
    charged ``work``; the plain versions never run, and nothing is
    launched."""
    for name in ("rmsnorm_reference", "mha_reference", "ssd_scan_reference"):
        monkeypatch.setattr(kref, name, lambda *a, name=name, **k: pytest.fail(f"{name} ran"))
    args = _kernel_inputs()
    c, (y, o, (ys, st)) = cost.count(_kernel_calls, *args)
    x, scale, q, k, v, xs, da, bm, cm = args
    want = {"rmsnorm": rms.work(x, scale), "flash_attention": fa.work(q, k, True, None),
            "ssd_scan": ssd.work(xs, da, bm, 8, True)}
    assert c.kernels == {n: {"calls": 1, "flops": f, "bytes": b} for n, (f, b) in want.items()}
    assert c.flops == sum(f for f, _ in want.values())
    assert c.bytes_accessed == sum(b for _, b in want.values())
    assert want["ssd_scan"][0] == ssd.ssd_ops(20, 16, 8, 8, 6, 3)
    assert want["flash_attention"] == (4 * 2 * 4 * fa.attention_pairs(24, 24, True, None) * 32,
                                       2 * (2 * 24 * 4 + 2 * 24 * 2) * 32 * 2)
    assert [tuple(t.shape) for t in (y, o, ys, st)] == [(10, 48), (2, 4, 24, 32), (6, 20, 16),
                                                       (6, 16, 8)]
    assert (y.dtype, o.dtype, ys.dtype, st.dtype) == (torch.bfloat16, torch.bfloat16,
                                                      torch.float32, torch.float32)
    assert y.is_meta and not torch.cuda.is_initialized()
    assert rms.rmsnorm.launches == fa.flash_attention.launches == ssd.ssd_scan.launches == 0


def test_kernel_7_backward_is_counted_op_by_op():
    """A gradient through kernel 7: the forward charged as the kernel, its
    PyTorch backward counted op by op, the (B, H, S, S) f32 probabilities
    among the temporaries, as the card allocates them."""
    b, h, s, hd = 2, 4, 64, 32
    q, k, v = (torch.empty(b, h, s, hd, device="meta") for _ in range(3))

    def loss(q, k, v):
        return fa.flash_attention(q, k, v, causal=True).sum()

    c, grads = cost.count(torch.func.grad(loss, argnums=(0, 1, 2)), q, k, v)
    assert c.kernels["flash_attention"]["calls"] == 1 and len(grads) == 3
    assert c.ops["_softmax"] == 1 and c.ops["bmm"] >= 4
    assert c.temp_size_bytes >= 2 * b * h * s * s * 4  # probabilities and their gradient


REDUCED = {"smollm-360m": SMALL, "whisper-small": dict(vocab=128),
           "zamba2-1.2b": dict(vocab=128), "xlstm-125m": dict(vocab=128)}
TINY_SHAPES = {"train_4k": InputShape("train_4k", 16, 64, "train"),
               "prefill_32k": InputShape("prefill_32k", 32, 2, "prefill"),
               "decode_32k": InputShape("decode_32k", 32, 2, "decode"),
               "long_500k": InputShape("long_500k", 64, 1, "decode")}


@pytest.mark.parametrize("arch,shape", [("smollm-360m", "train_4k"),
                                        ("smollm-360m", "prefill_32k"),
                                        ("zamba2-1.2b", "decode_32k"),
                                        ("whisper-small", "train_4k"),
                                        ("smollm-360m", "long_500k")])
def test_run_one_reduced(arch, shape, monkeypatch):
    """``run_one`` at reduced widths and tiny shapes: the reference's record,
    6ND (train) or 2ND over the active parameters, no CUDA."""
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", TINY_SHAPES)
    monkeypatch.setattr(dryrun, "_cfg_for", lambda a, s: configs.get_config(a).reduced(**REDUCED[a]))
    r = dryrun.run_one(arch, shape)
    if shape == "long_500k":
        assert r["status"] == "skip" and "long_500k" in r["reason"]
        return
    cfg = configs.get_config(arch).reduced(**REDUCED[arch])
    sh = TINY_SHAPES[shape]
    assert {k: r[k] for k in ("arch", "shape", "multi_pod", "status", "kind", "n_chips",
                              "round_mode", "collective_bytes", "collectives")} == {
        "arch": arch, "shape": shape, "multi_pod": False, "status": "ok", "kind": sh.kind,
        "n_chips": 1, "round_mode": cfg.round_mode, "collective_bytes": 0.0, "collectives": {}}
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(
        transformer.init_params(cfg, None, "meta"), is_leaf=lambda x: isinstance(x, torch.Tensor)))
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len)
    assert r["active_params"] == n and r["tokens_processed"] == tokens
    assert r["model_flops"] == (6.0 if sh.kind == "train" else 2.0) * n * tokens
    assert r["flops"] >= r["matmul_flops"] > 0 and r["bytes_accessed"] > 0
    mem = r["memory"]
    assert mem["argument_size_bytes"] > 0 and mem["temp_size_bytes"] > 0
    assert json.loads(json.dumps(r)) == r and not torch.cuda.is_initialized()
    if sh.kind == "train":  # the round's 16 clients, 2 local steps, recomputed groups
        assert r["kernels"]["flash_attention"]["calls"] > 0


def test_multi_rank_and_bad_opts_raise():
    for kw in (dict(multi_pod=True), dict(mesh_shape=(2, 1)), dict(opts=("seq_parallel",))):
        with pytest.raises(NotImplementedError, match="section 1, item 6, 'Multi-rank placement'"):
            dryrun.run_one("smollm-360m", "decode_32k", **kw)
    with pytest.raises(ValueError, match="unknown opt"):
        dryrun.run_one("smollm-360m", "decode_32k", ("nope",))
    cfg = dryrun._apply_opts(configs.get_config("xlstm-125m"),
                             ("remat_none", "mlstm_chunk_64", "slstm_seg_16", "attn_chunked", "moe_a2a"))
    assert (cfg.remat, cfg.mlstm_impl, cfg.mlstm_chunk, cfg.slstm_segment, cfg.attn_impl,
            cfg.moe_impl) == ("none", "chunked", 64, 16, "chunked", "a2a")


def _cli(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          capture_output=True, text=True, timeout=600, cwd=cwd,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


@pytest.mark.slow
def test_cli_full_width_decode_and_report(tmp_path):
    """The counterpart of ``tests/test_sharding_and_dryrun.py``: the CLI at
    full width, its JSON the last line, then the report over it."""
    proc = _cli("--arch", "xlstm-125m", "--shape", "decode_32k")
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["status"] == "ok" and r["kind"] == "decode" and r["flops"] > 0
    assert r["bytes_accessed"] > 0 and r["memory"]["argument_size_bytes"] > 0
    (tmp_path / "xlstm-125m__decode_32k__sp.json").write_text(json.dumps(r))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report", "--dir",
                          str(tmp_path)], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and "| xlstm-125m | decode_32k | 1xH100 | ok | decode |" in out.stdout
    assert math.isfinite(roofline.roofline(r["flops"], r["bytes_accessed"], 0.0, 1,
                                           r["model_flops"]).memory_s)


@pytest.mark.slow
def test_cli_multi_pod_raises():
    proc = _cli("--arch", "smollm-360m", "--shape", "train_4k", "--multi-pod")
    assert proc.returncode != 0 and "NotImplementedError" in proc.stderr
    assert "item 6, 'Multi-rank placement'" in proc.stderr
