"""The port's MoE FFN and the moe family against the JAX reference on the CPU.

``repro_torch.models.moe.moe_ffn`` is held to ``repro.models.moe.moe_ffn``
on the reference's weights (``init_params`` carried across with
``transformer.params_from_reference``) and the same activations: the
output and the load-balance loss in f32, and the routing (top-k expert
indices, slots, kept mask after the capacity drop) exactly, for reduced
qwen3-moe-235b-a22b (top-2 of 4 experts, q/k norm) and arctic-480b (dense
residual), dropless (the reduced configs' ``capacity_factor=8.0``) and
with drops (``capacity_factor=0.5``), with ``moe_impl="a2a"`` (no mesh:
the dense path in both packages).  Then ``loss_fn`` and its gradient
(``torch.func.grad`` against ``jax.grad``), the ``client_parallel`` round
under ``torch.func.vmap``, prefill + paged decode against the reference
and against the full forward, and the configs' parameter counts.
Tolerances: f32 ``rtol=1e-5, atol=1e-4`` (ROADMAP.md's rule); integers
and masks exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed.tasks import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
VARIANTS = {  # reduced() overrides beyond the vocab
    "dropless": {},
    "drops": {"capacity_factor": 0.5},
    "a2a": {"moe_impl": "a2a"},
}


def _cfgs(name, variant="dropless", **over):
    kw = dict(vocab=64, **VARIANTS[variant], **over)
    return ref_get_config(name).reduced(**kw), get_config(name).reduced(**kw)


def _weights(ref_cfg, cfg, seed=0):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_params, transformer.params_from_reference(np_params, cfg, "cpu")


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


def _ref_routing(router, cfg, xf):
    """The reference's routing steps (``repro/models/moe.py:moe_ffn``, from
    the router softmax to the capacity drop), in jnp: its function returns
    only the output and the loss."""
    gates = jax.nn.softmax(xf.astype(jnp.float32) @ router, axis=-1)
    _, top_idx = jax.lax.top_k(gates, cfg.top_k)
    cap = int(max(1, round(cfg.capacity_factor * xf.shape[0] * cfg.top_k / cfg.n_experts)))
    mask = jnp.sum(jax.nn.one_hot(top_idx, cfg.n_experts, dtype=jnp.float32), axis=1)
    position = jnp.cumsum(mask, axis=0) * mask - 1.0
    slot = jnp.take_along_axis(position, top_idx, axis=1).astype(jnp.int32)
    keep = jnp.logical_and(slot >= 0, slot < cap)
    return np.asarray(top_idx), np.asarray(slot), np.asarray(keep), cap


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_reference(name, variant):
    ref_cfg, cfg = _cfgs(name, variant)
    ref_params, params = _weights(ref_cfg, cfg)
    p_ref, p = ref_params["stacks"][0]["moe"], params["stacks"][0]["moe"]
    p_ref = jax.tree_util.tree_map(lambda a: a[0], p_ref)
    p = tree_map(lambda t: t[0], p)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_ffn(p_ref, ref_cfg, jnp.asarray(x))
    got, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32

    idx, slot, keep, cap = _ref_routing(p_ref["router"], ref_cfg, jnp.asarray(x.reshape(-1, cfg.d_model)))
    _, _, got_idx, _, got_slot, got_keep = moe.route(p["router"], cfg, torch.from_numpy(x.reshape(-1, cfg.d_model)))
    assert moe.capacity(cfg, x.shape[0] * x.shape[1]) == cap
    np.testing.assert_array_equal(got_idx.numpy(), idx)  # random f32 logits: no ties
    np.testing.assert_array_equal(got_slot.numpy(), slot)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    if variant == "drops":
        assert not keep.all()  # capacity 0.5 drops assignments
    else:
        assert keep.all()  # the reduced configs are dropless


def test_capacity_rounds_half_to_even():
    """Python's round, as the reference: arctic at 128 tokens (top-2 over 128
    experts) gets round(2.5) = 2 slots an expert; qwen3's decode at B = 8
    gets max(1, round(0.625)) = 1; arctic's at B = 8 max(1, round(0.156)) = 1."""
    assert moe.capacity(get_config("arctic-480b"), 128) == 2
    assert moe.capacity(get_config("qwen3-moe-235b-a22b"), 8) == 1
    assert moe.capacity(get_config("arctic-480b"), 8) == 1
    assert moe.capacity(get_config("qwen3-moe-235b-a22b"), 4096) == 320


@pytest.mark.parametrize("variant", ["dropless", "drops"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grad_match_reference(name, variant):
    ref_cfg, cfg = _cfgs(name, variant)
    ref_params, params = _weights(ref_cfg, cfg, seed=2)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=-1)
    ref_batch = (jnp.asarray(tok), jnp.asarray(tgt))
    batch = (torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    want_l, want_g = jax.jit(jax.value_and_grad(lambda q: ref_tf.loss_fn(q, ref_cfg, ref_batch)))(
        ref_params)
    got_g, got_l = torch.func.grad_and_value(lambda q: transformer.loss_fn(q, cfg, batch))(params)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    _, aux = transformer.forward(params, cfg, batch[0])
    _, want_aux = jax.jit(lambda q, t: ref_tf.forward(q, ref_cfg, t))(ref_params, ref_batch[0])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0
    for g, w in zip(tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_vmap_over_clients_equals_a_loop(name):
    """``torch.func.vmap`` of ``moe_ffn`` over clients' activations and
    their diverged parameters (the ``client_parallel`` round's batching)
    equals a loop over the clients, drops included."""
    _, cfg = _cfgs(name, "drops")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = tree_map(lambda a: a[0], params["stacks"][0]["moe"])
    gen = torch.Generator().manual_seed(1)
    ps = tree_map(lambda a: a + 0.01 * torch.randn((3,) + a.shape, generator=gen), p)
    xs = torch.randn(3, 2, 16, cfg.d_model, generator=gen)
    out, aux = torch.func.vmap(lambda q, x: moe.moe_ffn(q, cfg, x))(ps, xs)
    for c in range(3):
        o, a = moe.moe_ffn(tree_map(lambda t: t[c], ps), cfg, xs[c])
        torch.testing.assert_close(out[c], o, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(aux[c], a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_client_parallel_round_matches_reference(name):
    """The moe configs' ``round_mode`` is ``cohort_sequential``; the
    ``client_parallel`` override (the mode that takes compression) vmaps
    local training over the slots, in both packages."""
    from repro.fed import round as ref_round
    from repro_torch.fed import round as zoo_round

    ref_cfg, cfg = _cfgs(name, "drops")
    ref_cfg = dataclasses.replace(ref_cfg, round_mode="client_parallel")
    cfg = dataclasses.replace(cfg, round_mode="client_parallel")
    ref_params, params = _weights(ref_cfg, cfg, seed=4)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (3, 2, 2, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=-1)
    weights = np.array([1.7, 0.0, 2.4], np.float32)
    spec = dict(cohort=3, local_steps=2, local_lr=0.05, server_lr=0.8, local_batch=2)
    want = jax.jit(ref_round.build_round_step(ref_cfg, ref_round.RoundSpec(**spec)))(
        ref_params, jnp.asarray(tokens), jnp.asarray(targets), jnp.asarray(weights))
    got = zoo_round.build_round_step(cfg, zoo_round.RoundSpec(**spec))(
        params, torch.from_numpy(tokens), torch.from_numpy(targets), torch.from_numpy(weights))
    for g, w in zip(tree_leaves(got[0]), jax.tree_util.tree_leaves(want[0])):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_match_reference_and_forward(name):
    """Prefill and three paged decode steps equal the reference's; within
    the port, prefill + decode equal the full forward (dropless: a decode
    step's one token a sequence routes as in the forward)."""
    ref_cfg, cfg = _cfgs(name)
    ref_params, params = _weights(ref_cfg, cfg, seed=6)
    b, s, extra = 2, 13, 3
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (b, s + extra)).astype(np.int32)
    full, _ = transformer.forward(params, cfg, torch.from_numpy(tokens).long())
    ref_pre, ref_caches = jax.jit(lambda q, t: ref_tf.prefill(
        q, ref_cfg, t, max_seq=s + extra + 1, page_size=4))(ref_params, jnp.asarray(tokens[:, :s]))
    ref_decode = jax.jit(lambda q, t, c, i: ref_tf.decode_step(q, ref_cfg, t, c, i))
    pre, caches = transformer.prefill(params, cfg, torch.from_numpy(tokens[:, :s]).long(),
                                      max_seq=s + extra + 1, page_size=4)
    np.testing.assert_allclose(_np(pre), _np(ref_pre), **TOL)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, s - 1]), **TOL)
    for j, (c, rc) in enumerate(zip(caches, ref_caches)):
        np.testing.assert_array_equal(c["page_table"].numpy(), np.asarray(rc["page_table"]))
        np.testing.assert_allclose(_np(c["pool_k"]), _np(rc["pool_k"]), **TOL)
    for i in range(extra):
        tok = tokens[:, s + i : s + i + 1]
        ref_dec, ref_caches = ref_decode(ref_params, jnp.asarray(tok), ref_caches,
                                         jnp.asarray(s + i, jnp.int32))
        dec, caches = transformer.decode_step(params, cfg, torch.from_numpy(tok).long(), caches, s + i)
        np.testing.assert_allclose(_np(dec), _np(ref_dec), **TOL, err_msg=f"decode {i}")
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, s + i]), **TOL, err_msg=f"step {i}")


def test_kernel_calls_per_pass(monkeypatch):
    """qwen3 (q/k norm): kernel 6 four times a block plus the final norm in
    a forward, a prefill and a decode step; kernel 7 once a block in a
    forward or prefill, never in decode.  arctic: kernel 6 two times a
    block plus one."""
    from repro_torch.kernels import ops

    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ops, "rmsnorm", counted("rmsnorm", ops.rmsnorm))
    monkeypatch.setattr(ops, "flash_attention", counted("flash_attention", ops.flash_attention))
    for name, per_block in (("qwen3-moe-235b-a22b", 4), ("arctic-480b", 2)):
        cfg = get_config(name).reduced(vocab=64, n_layers=3)
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.zeros((2, 6), dtype=torch.int64)
        for k in calls:
            calls[k] = 0
        transformer.forward(params, cfg, tokens)
        want = {"rmsnorm": per_block * 3 + 1, "flash_attention": 3}
        assert calls == want, name
        _, caches = transformer.prefill(params, cfg, tokens, max_seq=8, page_size=4)
        assert calls == {k: 2 * v for k, v in want.items()}, name
        transformer.decode_step(params, cfg, tokens[:, :1], caches, 6)
        assert calls == {"rmsnorm": 3 * want["rmsnorm"], "flash_attention": 6}, name


@pytest.mark.parametrize("name,layers", [("qwen3-moe-235b-a22b", 1), ("qwen3-moe-235b-a22b", 2),
                                         ("arctic-480b", 1), ("arctic-480b", 35)])
def test_param_tree_and_count_match_reference(name, layers):
    """Full width, shapes only (``jax.eval_shape`` against the port's
    ``meta`` tree): the same leaves, shapes and dtypes, and the same count
    (qwen3 one layer 3,732,418,816; two 6,220,173,824; arctic one layer
    14,069,945,344)."""
    ref_cfg = dataclasses.replace(ref_get_config(name), n_layers=layers)
    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    shapes = jax.eval_shape(lambda: ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    tree = transformer._init_tree(cfg, None)
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), tree)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), jnp.dtype(a.dtype).name), shapes)
    assert got == want
    assert transformer.param_count(tree) == ref_tf.param_count(shapes)


def test_params_from_reference_refuses_a_foreign_tree():
    ref_cfg, cfg = _cfgs("arctic-480b")
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    del tree["stacks"][0]["moe"]["dense"]
    with pytest.raises(ValueError, match="moe"):
        transformer.params_from_reference(tree, cfg, "cpu")


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["dropless", "drops"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_on_card_matches_cpu(name, variant, cuda):
    """f32 on the card (kernels 6-7 in the forward) against the CPU: the
    routing exactly, loss and gradients within the f32 tolerance, and two
    gradients on the card bitwise equal (the scatter-adds' collisions add
    exact zeros)."""
    cfg = get_config(name).reduced(vocab=64, **VARIANTS[variant])
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    batch = (tok, torch.roll(tok, -1, -1))
    dev = tree_map(lambda t: t.to(cuda), params)
    dev_batch = tuple(t.to(cuda) for t in batch)

    def grads(p, b):
        return torch.func.grad_and_value(lambda q: transformer.loss_fn(q, cfg, b))(p)

    g_cpu, l_cpu = grads(params, batch)
    g_a, l_a = grads(dev, dev_batch)
    g_b, l_b = grads(dev, dev_batch)
    np.testing.assert_allclose(float(l_a), float(l_cpu), rtol=1e-5)
    for a, b, c in zip(tree_leaves(g_a), tree_leaves(g_b), tree_leaves(g_cpu)):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), **TOL)
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(2))
    router = params["stacks"][0]["moe"]["router"][0]
    r_cpu = moe.route(router, cfg, x)
    r_gpu = moe.route(router.to(cuda), cfg, x.to(cuda))
    for a, b in zip(r_gpu[2:], r_cpu[2:]):
        assert torch.equal(a.cpu(), b)
