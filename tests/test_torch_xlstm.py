"""The port's xLSTM blocks and the xlstm family against the JAX reference on
the CPU.

Each function of ``repro_torch.models.xlstm`` is held to its namesake in
``repro.models.xlstm`` on the reference's weights (``init_mlstm`` /
``init_slstm`` trees) and the same numpy inputs: the mLSTM cell, block
(``mlstm_impl`` "scan" and "chunked"), decode step and state; the
chunkwise form and its final state (against the reference's and against a
chain of decode steps, as ``tests/test_perf_variants.py`` holds the
reference's); the sLSTM gates, cell (with and without ``slstm_segment``,
whose recompute runs under ``backward()`` and ``torch.func``),
block, decode step and state.  Then reduced xlstm-125m through
``forward`` / ``loss_fn`` and its gradient, prefill + decode against the
reference and against the full forward, and the parameter count at full
size.  Tolerances: f32 ``rtol=1e-5, atol=1e-4`` (ROADMAP.md's rule).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models import xlstm as ref_x  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed.tasks import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import transformer, xlstm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
NAME = "xlstm-125m"


def _cfgs(**over):
    kw = dict(vocab=64, **over)
    return ref_get_config(NAME).reduced(**kw), get_config(NAME).reduced(**kw)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _cell_params(init, ref_cfg, seed=0):
    """A reference block's weights (``init_mlstm`` / ``init_slstm``) in
    both packages."""
    ref_p = init(ref_cfg, jax.random.PRNGKey(seed))
    return ref_p, {k: _t(v) for k, v in ref_p.items()}


def _qkv_gates(b=2, s=24, h=4, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3))
    ig = (2.0 * rng.standard_normal((b, s, h))).astype(np.float32)
    fg = (2.0 * rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def test_mlstm_cell_matches_reference():
    q, k, v, ig, fg = _qkv_gates()
    want = ref_x._mlstm_cell(*map(jnp.asarray, (q, k, v, ig, fg)))
    got = xlstm._mlstm_cell(*map(_t, (q, k, v, ig, fg)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("chunk", [8, 16, 128])
def test_mlstm_chunked_matches_reference_and_cell(chunk):
    """Output and final (C, n, m) state against the reference's chunked
    form; the output against the port's own cell."""
    q, k, v, ig, fg = _qkv_gates(s=48, seed=1)
    want, want_state = ref_x.mlstm_chunked(*map(jnp.asarray, (q, k, v, ig, fg)), chunk=chunk)
    got, state = xlstm.mlstm_chunked(*map(_t, (q, k, v, ig, fg)), chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b in zip(state, want_state):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    cell = xlstm._mlstm_cell(*map(_t, (q, k, v, ig, fg)))
    np.testing.assert_allclose(_np(got), _np(cell), atol=2e-3, rtol=2e-3)


def test_mlstm_chunked_final_state_matches_decode_chain():
    """The chunked final state continues as a chain of decode cells would
    leave it (``tests/test_perf_variants.py``'s check, on the port)."""
    b, s, h, hd = 1, 64, 2, 16
    q, k, v, ig, fg = _qkv_gates(b, s, h, hd, seed=2)
    _, (c_chk, n_chk, m_chk) = xlstm.mlstm_chunked(*map(_t, (q, k, v, ig, fg)), chunk=16)
    scale = hd**-0.5
    c, n = torch.zeros(b, h, hd, hd), torch.zeros(b, h, hd)
    m = torch.full((b, h), -torch.inf)
    lf = torch.nn.functional.logsigmoid(_t(fg))
    for t in range(s):
        c, n, m, _ = xlstm._mlstm_step(c, n, m, _t(q[:, t]) * scale, _t(k[:, t]) * scale,
                                       _t(v[:, t]), lf[:, t], _t(ig[:, t]))
    np.testing.assert_allclose(_np(c_chk), _np(c), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(n_chk), _np(n), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(m_chk), _np(m), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_mlstm_block_matches_reference(impl):
    ref_cfg, cfg = _cfgs(mlstm_impl=impl, mlstm_chunk=8)
    ref_p, p = _cell_params(ref_x.init_mlstm, ref_cfg)
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want = ref_x.mlstm_block(ref_p, ref_cfg, jnp.asarray(x))
    got = xlstm.mlstm_block(p, cfg, _t(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_init_trees_and_states_match_reference():
    ref_cfg, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for ref_init, init in ((ref_x.init_mlstm, xlstm.init_mlstm), (ref_x.init_slstm, xlstm.init_slstm)):
        want = ref_init(ref_cfg, jax.random.PRNGKey(0))
        got = init(cfg, gen)
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
        assert {k: str(v.dtype)[6:] for k, v in got.items()} == {
            k: jnp.dtype(v.dtype).name for k, v in want.items()}
        # uniform_init's range: fan-in is the leading axis (r's is n_heads)
        for k, v in got.items():
            if k not in ("if_bias", "norm_scale", "bias"):
                bound = 0.5 if k == "conv_w" else v.shape[0] ** -0.5
                assert float(v.abs().max()) <= bound
    for ref_state, state in ((ref_x.init_mlstm_state, xlstm.init_mlstm_state),
                             (ref_x.init_slstm_state, xlstm.init_slstm_state)):
        want, got = ref_state(ref_cfg, 3), state(cfg, 3, device="cpu")
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _state_pair(ref_state, state, ref_cfg, cfg, b, seed):
    """A non-trivial recurrent state in both packages: the fresh state with
    small random entries added to its zeros."""
    rng = np.random.default_rng(seed)
    ref_s, s = ref_state(ref_cfg, b), state(cfg, b, device="cpu")
    out_ref, out = {}, {}
    for k, v in ref_s.items():
        arr = np.asarray(v).copy()
        if k != "m":
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(np.float32)
        else:
            arr = (0.5 * rng.standard_normal(arr.shape)).astype(np.float32)
        out_ref[k] = jnp.asarray(arr)
        out[k] = s[k].copy_(torch.from_numpy(arr))
    return out_ref, out


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_reference_and_update_in_place(kind):
    ref_cfg, cfg = _cfgs()
    init = (ref_x.init_mlstm, ref_x.init_mlstm_state, xlstm.init_mlstm_state,
            ref_x.mlstm_decode_step, xlstm.mlstm_decode_step)
    if kind == "slstm":
        init = (ref_x.init_slstm, ref_x.init_slstm_state, xlstm.init_slstm_state,
                ref_x.slstm_decode_step, xlstm.slstm_decode_step)
    ref_init, ref_state, state_init, ref_step, step = init
    ref_p, p = _cell_params(ref_init, ref_cfg, seed=4)
    ref_s, s = _state_pair(ref_state, state_init, ref_cfg, cfg, 2, seed=5)
    ptrs = {k: v.data_ptr() for k, v in s.items()}
    x = np.random.default_rng(6).standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    for t in range(3):
        want, ref_s = ref_step(ref_p, ref_cfg, jnp.asarray(x[:, t : t + 1]), ref_s)
        got, s2 = step(p, cfg, _t(x[:, t : t + 1]), s)
        assert s2 is s and {k: v.data_ptr() for k, v in s.items()} == ptrs
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"{kind} step {t}")
        for k in s:
            np.testing.assert_allclose(_np(s[k]), _np(ref_s[k]), **TOL, err_msg=f"{kind} {k}")


def test_slstm_gates_cell_and_block_match_reference():
    ref_cfg, cfg = _cfgs()
    ref_p, p = _cell_params(ref_x.init_slstm, ref_cfg, seed=7)
    d, h = cfg.d_model, cfg.n_heads
    rng = np.random.default_rng(8)
    pre = rng.standard_normal((2, 4 * d)).astype(np.float32)
    h_prev = rng.standard_normal((2, d)).astype(np.float32)
    np.testing.assert_allclose(
        _np(xlstm._slstm_gates(_t(pre), _t(h_prev), p, h, d // h)),
        _np(ref_x._slstm_gates(jnp.asarray(pre), jnp.asarray(h_prev), ref_p, h, d // h)), **TOL)
    x_pre = rng.standard_normal((2, 16, 4 * d)).astype(np.float32)
    want = ref_x._slstm_cell(ref_p, jnp.asarray(x_pre), h, d // h)
    for segment in (0, 4):
        got = xlstm._slstm_cell(p, _t(x_pre), h, d // h, segment=segment)
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"segment {segment}")
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    np.testing.assert_allclose(_np(xlstm.slstm_block(p, cfg, _t(x))),
                               _np(ref_x.slstm_block(ref_p, ref_cfg, jnp.asarray(x))), **TOL)


def test_slstm_segment_recomputes_under_backward_and_torch_func():
    """``slstm_segment`` changes memory, not values: the recomputed loop
    gives the gradients of the plain one (and of the reference's
    ``jax.checkpoint``) under ``backward()``, and under ``torch.func.grad``
    and ``vmap(grad)``, where it used to raise.  The gradient of ``r`` sums
    the steps a segment at a time, so it is held to f32 rounding, not
    bitwise."""
    ref_cfg, cfg = _cfgs(slstm_segment=4)
    ref_p, _ = _cell_params(ref_x.init_slstm, ref_cfg, seed=9)
    x = np.random.default_rng(10).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want = jax.jit(jax.grad(lambda q: jnp.sum(ref_x.slstm_block(q, ref_cfg, jnp.asarray(x)) ** 2)))(
        ref_p)
    grads, func_grads, vmapped = {}, {}, {}
    p = {k: _t(v) for k, v in ref_p.items()}
    xs = _t(x).reshape(2, 1, 16, cfg.d_model)
    for segment in (0, 4):
        c = dataclasses.replace(cfg, slstm_segment=segment)
        leaves = {k: _t(v).requires_grad_() for k, v in ref_p.items()}
        (xlstm.slstm_block(leaves, c, _t(x)) ** 2).sum().backward()
        grads[segment] = {k: v.grad for k, v in leaves.items()}

        def loss(q, xx, c=c):
            return (xlstm.slstm_block(q, c, xx) ** 2).sum()

        func_grads[segment] = torch.func.grad(loss)(p, _t(x))
        vmapped[segment] = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(p, xs)
    for k in grads[0]:
        for got in (grads, func_grads):
            torch.testing.assert_close(got[4][k], got[0][k], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(_np(got[4][k]), _np(want[k]), **TOL, err_msg=k)
        torch.testing.assert_close(vmapped[4][k][0], vmapped[0][k][0], rtol=1e-6, atol=1e-7)
    # a segment that does not divide S takes the plain loop, as the reference's
    c = dataclasses.replace(cfg, slstm_segment=5)
    got = torch.func.grad(lambda q: (xlstm.slstm_block(q, c, _t(x)) ** 2).sum())(p)
    for k in got:
        torch.testing.assert_close(got[k], func_grads[0][k], rtol=0, atol=0)


def _weights(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_params, transformer.params_from_reference(np_params, cfg, "cpu")


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_loss_and_grad_match_reference(impl):
    ref_cfg, cfg = _cfgs(mlstm_impl=impl, mlstm_chunk=8)
    ref_params, params = _weights(ref_cfg, cfg, seed=11)
    tok = np.random.default_rng(12).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=-1)
    ref_batch = (jnp.asarray(tok), jnp.asarray(tgt))
    batch = (torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    logits, aux = transformer.forward(params, cfg, batch[0])
    ref_logits, _ = jax.jit(lambda q, t: ref_tf.forward(q, ref_cfg, t))(ref_params, ref_batch[0])
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL)
    assert float(aux) == 0.0
    want_l, want_g = jax.jit(jax.value_and_grad(lambda q: ref_tf.loss_fn(q, ref_cfg, ref_batch)))(
        ref_params)
    got_g, got_l = torch.func.grad_and_value(lambda q: transformer.loss_fn(q, cfg, batch))(params)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    for g, w in zip(tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_prefill_decode_match_reference_and_forward():
    """Prefill (the decode cell over the prompt) and three decode steps
    equal the reference's, recurrent caches included; within the port,
    prefill + decode equal the full forward."""
    ref_cfg, cfg = _cfgs()
    ref_params, params = _weights(ref_cfg, cfg, seed=13)
    b, s, extra = 2, 13, 3
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, (b, s + extra)).astype(np.int32)
    full, _ = transformer.forward(params, cfg, torch.from_numpy(tokens).long())
    ref_pre, ref_caches = jax.jit(lambda q, t: ref_tf.prefill(
        q, ref_cfg, t, max_seq=s + extra + 1, page_size=4))(ref_params, jnp.asarray(tokens[:, :s]))
    ref_decode = jax.jit(lambda q, t, c, i: ref_tf.decode_step(q, ref_cfg, t, c, i))
    pre, caches = transformer.prefill(params, cfg, torch.from_numpy(tokens[:, :s]).long(),
                                      max_seq=s + extra + 1, page_size=4)
    np.testing.assert_allclose(_np(pre), _np(ref_pre), **TOL)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, s - 1]), **TOL)
    for c, rc in zip(caches, ref_caches):
        assert sorted(c) == sorted(rc)
        for k in c:
            np.testing.assert_allclose(_np(c[k]), _np(rc[k]), **TOL, err_msg=k)
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    for i in range(extra):
        tok = tokens[:, s + i : s + i + 1]
        ref_dec, ref_caches = ref_decode(ref_params, jnp.asarray(tok), ref_caches,
                                         jnp.asarray(s + i, jnp.int32))
        dec, caches = transformer.decode_step(params, cfg, torch.from_numpy(tok).long(), caches, s + i)
        np.testing.assert_allclose(_np(dec), _np(ref_dec), **TOL, err_msg=f"decode {i}")
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, s + i]), **TOL, err_msg=f"step {i}")
    assert [t.data_ptr() for t in tree_leaves(caches)] == ptrs
    empty = transformer.init_caches(cfg, b, s + extra + 1, page_size=4, device="cpu")
    assert [sorted(c) for c in empty] == [sorted(c) for c in caches]


def test_kernel6_calls_per_pass(monkeypatch):
    """Kernel 6 two times a block plus the final norm in a forward and a
    decode step; in a prefill of S tokens two times an mLSTM block (its
    ``ln1`` and inner norm over the prompt), 1 + S times an sLSTM block
    (the decode cell a token at a time) plus the final norm; kernel 7
    never."""
    from repro_torch.kernels import ops

    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ops, "rmsnorm", counted("rmsnorm", ops.rmsnorm))
    monkeypatch.setattr(ops, "flash_attention", counted("flash_attention", ops.flash_attention))
    cfg = get_config(NAME).reduced(vocab=64, n_layers=4)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 6), dtype=torch.int64)
    transformer.forward(params, cfg, tokens)
    assert calls == {"rmsnorm": 2 * 4 + 1, "flash_attention": 0}
    _, caches = transformer.prefill(params, cfg, tokens, max_seq=8)
    assert calls == {"rmsnorm": 9 + 2 * 2 + 2 * (1 + 6) + 1, "flash_attention": 0}
    transformer.decode_step(params, cfg, tokens[:, :1], caches, 6)
    assert calls == {"rmsnorm": 9 + 19 + 9, "flash_attention": 0}


def test_param_tree_and_count_match_reference():
    """Full size, shapes only: the reference's leaves, shapes and dtypes and
    its count, 134,337,840."""
    shapes = jax.eval_shape(lambda: ref_tf.init_params(ref_get_config(NAME), jax.random.PRNGKey(0)))
    tree = transformer._init_tree(get_config(NAME), None)
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), jnp.dtype(a.dtype).name), shapes)
    assert got == want
    assert transformer.param_count(tree) == ref_tf.param_count(shapes) == 134_337_840


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_xlstm_on_card_matches_cpu(impl, cuda):
    """f32 on the card (kernel 6 for the block and inner norms): loss and
    gradients within the f32 tolerance of the CPU's; prefill + decode
    within it too, with the caches at fixed addresses."""
    cfg = get_config(NAME).reduced(vocab=64, mlstm_impl=impl, mlstm_chunk=8)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    batch = (tok, torch.roll(tok, -1, -1))
    dev = tree_map(lambda t: t.to(cuda), params)

    def grads(p, b):
        return torch.func.grad_and_value(lambda q: transformer.loss_fn(q, cfg, b))(p)

    g_cpu, l_cpu = grads(params, batch)
    g_gpu, l_gpu = grads(dev, tuple(t.to(cuda) for t in batch))
    np.testing.assert_allclose(float(l_gpu), float(l_cpu), rtol=1e-5)
    for a, c in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), **TOL)
    pre_c, caches_c = transformer.prefill(params, cfg, tok[:, :12], max_seq=16)
    pre_g, caches_g = transformer.prefill(dev, cfg, tok[:, :12].to(cuda), max_seq=16)
    np.testing.assert_allclose(pre_g.cpu().numpy(), pre_c.numpy(), **TOL)
    ptrs = [t.data_ptr() for t in tree_leaves(caches_g)]
    for i in range(3):
        dc, caches_c = transformer.decode_step(params, cfg, tok[:, 12 + i : 13 + i], caches_c, 12 + i)
        dg, caches_g = transformer.decode_step(dev, cfg, tok[:, 12 + i : 13 + i].to(cuda), caches_g, 12 + i)
        np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(), **TOL)
    assert [t.data_ptr() for t in tree_leaves(caches_g)] == ptrs
