"""The vlm and audio families of the port against the JAX reference on the
CPU: llama-3.2-vision-11b (gated ``cross_attn`` blocks over projected patch
embeddings) and whisper-small (an ``enc`` encoder over frame embeddings,
``dec`` blocks with self- and cross-attention).

Reduced configs in f32 (16 frontend positions), the reference's weights
carried across with ``params_from_reference`` and the same numpy tokens and
``aux_embeds`` in both packages.  The vlm's gates are zero at init, which
would hide its cross path from every output, so they are set to 0.5 in the
shared numpy tree first.  Tolerances: ROADMAP.md's f32 rule (``rtol=1e-5,
atol=1e-4``) on outputs, 1e-5 of each leaf's scale on parameters after a
round (``tests/test_torch_zoo_round.py``).

Kernel 7 meets two new modes here: bidirectional self-attention (whisper's
encoder) and cross-attention with S_q != S_k.  Its plain version is held to
the Pallas kernel in interpret mode at such shapes; the tests marked
``cuda`` hold the CUDA kernels to the plain version at the full-width
shapes (S_k = 1500 and 1601, ragged against the 64-key tiles) and skip
elsewhere (``python3 tests/run_cuda.py -k frontends`` on a machine with the
card).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.fed import round as ref_round  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed import round as zoo_round  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
LEAF_SCALE_TOL = 1e-5
ARCHS = {"whisper": "whisper-small", "vlm": "llama-3.2-vision-11b"}
FULL_PARAMS = {"whisper": 239_802_624, "vlm": 9_780_400_136}
GATE = 0.5


# The reference's functions jitted (the config static): one compile each,
# several times faster here than their op-by-op dispatch.
REF_FORWARD = jax.jit(ref_tf.forward, static_argnums=1)
REF_LOSS_GRAD = jax.jit(jax.value_and_grad(ref_tf.loss_fn), static_argnums=1)
REF_PREFILL = jax.jit(ref_tf.prefill, static_argnums=1, static_argnames=("max_seq", "page_size"))
REF_DECODE = jax.jit(ref_tf.decode_step, static_argnums=1)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


@functools.cache
def _weights(arch, seed=0):
    """The reference's reduced weights (the vlm's gates at ``GATE``) in both
    packages: (ref_cfg, ref_params, cfg, params), made once a file (no test
    writes to them)."""
    ref_cfg, cfg = ref_get_config(ARCHS[arch]).reduced(), get_config(ARCHS[arch]).reduced()
    tree = jax.tree_util.tree_map(np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    for slot in tree["stacks"]:
        if "gate" in slot:
            slot["gate"] = np.full_like(slot["gate"], GATE)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    return ref_cfg, ref_params, cfg, transformer.params_from_reference(tree, cfg, "cpu")


def _inputs(cfg, shape, seed=1):
    """Tokens of ``shape`` and frontend embeddings (..., frontend_seq,
    frontend_dim), standard normal f32, for the batch dims of ``shape``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    aux = rng.standard_normal((*shape[:-1], cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return tokens, aux


def _t(a):
    return torch.from_numpy(a)


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_matches_reference_and_full_width_count(arch):
    """The port's config equals the reference's field for field; at full
    width the parameter tree (shapes only, the ``meta`` device) holds the
    reference's count."""
    want, got = ref_get_config(ARCHS[arch]), get_config(ARCHS[arch])
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "param_dtype":
            assert str(b).removeprefix("torch.") == jnp.dtype(a).name
        else:
            assert a == b, f"{arch}.{f.name}: {a!r} != {b!r}"
    tree = transformer._init_tree(got, None)
    assert transformer.param_count(tree) == FULL_PARAMS[arch]
    shapes = jax.eval_shape(lambda: ref_tf.init_params(want, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), tree) == jax.tree_util.tree_map(
        lambda x: tuple(x.shape), shapes)


# -- the new pieces alone --------------------------------------------------------


def test_encode_matches_reference():
    ref_cfg, ref_params, cfg, params = _weights("whisper")
    _, frames = _inputs(cfg, (2, 1))
    want = jax.jit(ref_tf._encode, static_argnums=1)(ref_params, ref_cfg, jnp.asarray(frames))
    got = transformer._encode(params, cfg, _t(frames))
    assert got.shape == (2, cfg.frontend_seq, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cross_attention_matches_reference(arch):
    """``attention.cross_attention`` (S_q = 11 queries over 16 source
    positions, the vlm with 2 query heads a KV head) and the public
    bidirectional ``attention(causal=False)`` against the reference's."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    j = cfg.block_pattern.index("cross_attn" if arch == "vlm" else "dec")
    key = "xattn" if arch == "whisper" else "attn"
    ref_blk = jax.tree_util.tree_map(lambda a: a[0], ref_params["stacks"][j][key])
    blk = {k: v[0] for k, v in params["stacks"][j][key].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    want = ref_attention.cross_attention(ref_blk, ref_cfg, jnp.asarray(x), jnp.asarray(src))
    got = attention.cross_attention(blk, cfg, _t(x), _t(src))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    want = ref_attention.attention(ref_blk, ref_cfg, jnp.asarray(x), causal=False)
    got = attention.attention(blk, cfg, _t(x), causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# -- forward, loss, gradients, serving --------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_loss_and_grad_match_reference(arch):
    """Logits, the loss and its gradient (``torch.func.grad`` against
    ``jax.grad``), every leaf within 1e-5 of its scale; the gates'
    gradients are nonzero."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    tokens, aux = _inputs(cfg, (2, 13))
    ref_logits, _ = REF_FORWARD(ref_params, ref_cfg, jnp.asarray(tokens), jnp.asarray(aux))
    logits, moe_aux = transformer.forward(params, cfg, _t(tokens), _t(aux))
    assert logits.shape == (2, 13, cfg.vocab) and float(moe_aux) == 0.0
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL)

    targets = np.roll(tokens, -1, axis=-1)
    ref_batch = tuple(jnp.asarray(a) for a in (tokens, targets, aux))
    want_l, want_g = REF_LOSS_GRAD(ref_params, ref_cfg, ref_batch)
    got_g, got_l = torch.func.grad_and_value(transformer.loss_fn)(
        params, cfg, (_t(tokens), _t(targets), _t(aux)))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    got_leaves, want_leaves = tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = _np(w)
        assert float(np.abs(_np(g) - w).max()) <= LEAF_SCALE_TOL * max(float(np.abs(w).max()), 1e-30)
    if arch == "vlm":
        gate = got_g["stacks"][cfg.block_pattern.index("cross_attn")]["gate"]
        assert gate.shape == (1,) and float(gate.abs().min()) > 0.0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_reference_and_forward(arch, paged):
    """``prefill`` (the cross caches and the self caches, dense or paged)
    and three ``decode_step``s against the reference's, and each step's
    logits against the full forward's at that position
    (``tests/test_arch_smoke.py``'s prefill-plus-decode check)."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    s, extra = 9, 3
    tokens, aux = _inputs(cfg, (2, s + extra))
    page = dict(page_size=4) if paged else {}
    full, _ = transformer.forward(params, cfg, _t(tokens), _t(aux))
    ref_pre, ref_caches = REF_PREFILL(ref_params, ref_cfg, jnp.asarray(tokens[:, :s]),
                                         jnp.asarray(aux), max_seq=s + extra, **page)
    pre, caches = transformer.prefill(params, cfg, _t(tokens[:, :s]), _t(aux), max_seq=s + extra,
                                      **page)
    np.testing.assert_allclose(_np(pre), _np(ref_pre), **TOL)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, s - 1]), **TOL)
    got_c, want_c = tree_leaves(caches), jax.tree_util.tree_leaves(ref_caches)
    assert [tuple(c.shape) for c in got_c] == [tuple(c.shape) for c in want_c]
    for c, w in zip(got_c, want_c):
        np.testing.assert_allclose(_np(c), _np(w), **TOL)
    for i in range(extra):
        tok = tokens[:, s + i : s + i + 1]
        ref_dec, ref_caches = REF_DECODE(ref_params, ref_cfg, jnp.asarray(tok), ref_caches,
                                                 jnp.int32(s + i))
        dec, caches = transformer.decode_step(params, cfg, _t(tok), caches, s + i)
        np.testing.assert_allclose(_np(dec), _np(ref_dec), **TOL, err_msg=f"decode {i}")
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, s + i]), **TOL)


def _forward_calls(cfg) -> dict:
    """Kernels 6 and 7 a forward or prefill: whisper (E encoder, L decoder
    layers) (2E + 1) + (3L + 1) and E + 2L; the vlm 2L + 1 and L."""
    if cfg.encoder_layers:
        e, n = cfg.encoder_layers, cfg.n_layers
        return {"rmsnorm": 2 * e + 1 + 3 * n + 1, "flash_attention": e + 2 * n}
    return {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_kernel_calls_per_pass_and_step(arch, monkeypatch):
    """The wrappers of kernels 6 and 7 are called ``_forward_calls`` times a
    forward and a prefill; a decode step calls kernel 6 once a decoder norm
    plus the final norm and kernel 7 never (it reads the cross cache in
    plain torch)."""
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ops, "rmsnorm", counted("rmsnorm", ops.rmsnorm))
    monkeypatch.setattr(ops, "flash_attention", counted("flash_attention", ops.flash_attention))
    cfg = get_config(ARCHS[arch]).reduced(vocab=64)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens, aux = (_t(a) for a in _inputs(cfg, (2, 6)))
    want = _forward_calls(cfg)
    transformer.forward(params, cfg, tokens, aux)
    assert calls == want
    calls.update(rmsnorm=0, flash_attention=0)
    _, caches = transformer.prefill(params, cfg, tokens, aux, max_seq=8, page_size=4)
    assert calls == want
    calls.update(rmsnorm=0, flash_attention=0)
    transformer.decode_step(params, cfg, tokens[:, :1], caches, 6)
    per_layer = 3 if cfg.encoder_layers else 2
    assert calls == {"rmsnorm": per_layer * cfg.n_layers + 1, "flash_attention": 0}


# -- the round step -------------------------------------------------------------

ROUND_CASES = {  # arch, round mode, compression
    "whisper_client_parallel": ("whisper", "client_parallel", None),
    "whisper_int8_error_feedback": ("whisper", "client_parallel", "int8"),
    "vlm_cohort_sequential": ("vlm", "cohort_sequential", None),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_round_step_with_aux_matches_reference(case):
    """``build_round_step``'s ``round_step(params, tokens, targets, weights,
    aux_embeds[, resid=])`` against the reference's on the same inputs (C =
    3, R = 2, B = 2, S = 8; slot 1 at w = 0): parameters within 1e-5 of
    each leaf's scale, norms and loss within 1e-5.  With int8 and error
    feedback a code may flip where the two packages' scaled deltas straddle
    a rounding boundary; the new parameters and residual are then held to
    one quantization step of the update's scale.  Then the w = 0 slot is
    inert: other tokens and embeddings there change its norm and nothing
    else."""
    arch, mode, comp = ROUND_CASES[case]
    ref_cfg, ref_params, cfg, params = _weights(arch)
    assert cfg.round_mode == mode
    tokens, aux = _inputs(cfg, (3, 2, 2, 8))
    targets = np.roll(tokens, -1, axis=-1)
    weights = np.array([1.7, 0.0, 2.4], np.float32)
    kw = dict(cohort=3, local_steps=2, local_lr=0.05, server_lr=0.8, local_batch=2)
    port_spec = zoo_round.RoundSpec(**kw)
    ref_spec = ref_round.RoundSpec(**kw)
    ref_args = [ref_params, *(jnp.asarray(a) for a in (tokens, targets, weights, aux))]
    args = [params, *(_t(a) for a in (tokens, targets, weights, aux))]
    if comp is not None:
        port_spec = dataclasses.replace(port_spec, compression=api.CompressionSpec(
            delta_dtype=comp, error_feedback=True))
        ref_spec = dataclasses.replace(ref_spec, compression=ref_api.CompressionSpec(
            delta_dtype=comp, error_feedback=True))
        d = transformer.param_count(params)
        resid = np.random.default_rng(4).standard_normal(d).astype(np.float32) * 1e-4
    want = jax.jit(ref_round.build_round_step(ref_cfg, ref_spec))(
        *ref_args, *([jnp.asarray(resid)] if comp else []))
    step = zoo_round.build_round_step(cfg, port_spec)
    got = step(*args, **({"resid": _t(resid)} if comp else {}))
    assert len(got) == len(want) == (4 if comp else 3)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    moved = [np.abs(_np(w) - _np(p)).max() for w, p in
             zip(jax.tree_util.tree_leaves(want[0]), jax.tree_util.tree_leaves(ref_params))]
    for g, w, m in zip(tree_leaves(got[0]), jax.tree_util.tree_leaves(want[0]), moved):
        w = _np(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        tol = LEAF_SCALE_TOL * scale + (m / 127 if comp else 0.0)
        assert float(np.abs(_np(g) - w).max()) <= tol
    if comp:
        np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=0,
                                   atol=max(float(max(moved)) / 127, 1e-6))
    # The w = 0 slot is inert.
    tokens2, aux2 = tokens.copy(), aux.copy()
    tokens2[1] = (tokens2[1] + 7) % cfg.vocab
    aux2[1] = -aux2[1]
    again = step(params, _t(tokens2), args[2], args[3], _t(aux2),
                 **({"resid": _t(resid)} if comp else {}))
    for a, b in zip(tree_leaves(got[0]), tree_leaves(again[0])):
        assert torch.equal(a, b)
    assert float(again[2]) == float(got[2]) and float(again[1][1]) != float(got[1][1])


# -- where the reference fails, the port fails --------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_missing_frontend_embeddings_raise(arch):
    """``forward`` and ``prefill`` of a frontend arch without ``aux_embeds``
    raise ``ValueError`` naming them; the reference fails there with an
    ``AttributeError`` on ``None`` (ROADMAP.md, differences by design).  A
    decode step takes no ``aux_embeds``.  ``ServeEngine`` refuses the arch
    with the reference's ``ValueError``, and so ``launch.serve --arch``
    fails with it."""
    ref_cfg, ref_params, cfg, params = _weights(arch)
    tokens, _ = _inputs(cfg, (2, 5))
    with pytest.raises(AttributeError):
        ref_tf.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    for fn in (transformer.forward, transformer.prefill):
        with pytest.raises(ValueError, match="needs its frontend embeddings: pass aux_embeds"):
            fn(params, cfg, _t(tokens))
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine

    with pytest.raises(ValueError, match="frontend"):
        ServeEngine(cfg, params, batch=2, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        serve.main(["--arch", ARCHS[arch], "--reduced", "--device", "cpu", "--prompt-len", "4",
                    "--new-tokens", "2", "--page-size", "4"])


# -- kernel 7 in its new modes --------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s_q,s_k,g", [(16, 48, 2), (48, 16, 1), (16, 16, 3)])
def test_flash_attention_cross_plain_matches_pallas(dtype, s_q, s_k, g):
    """The plain version of kernel 7 (``kernels.ref.mha_reference``),
    bidirectional, S_q != S_k, with GQA, against the Pallas kernel in
    interpret mode (blocks of 16) with K/V expanded over the groups."""
    t_dt, j_dt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    rng = np.random.default_rng(s_q + s_k + g)
    kv, hd = 2, 32
    q = rng.standard_normal((kv * g, s_q, hd)).astype(np.float32)
    k, v = (rng.standard_normal((kv, s_k, hd)).astype(np.float32) for _ in range(2))
    got = ops.flash_attention(*(_t(a).to(t_dt) for a in (q, k, v)), causal=False, q_groups=g)
    k_x, v_x = (jnp.repeat(jnp.asarray(a, j_dt), g, axis=0) for a in (k, v))
    want = jax_flash(jnp.asarray(q, j_dt), k_x, v_x, causal=False, block_q=16, block_k=16,
                     interpret=True)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32), **tol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _bf16_out_tol(want):
    """4 bf16 ulps of the largest |output| (``chip_smoke.bf16_out_tol``): a
    non-causal output averages many keys and stays far below 1."""
    top = float(want.float().abs().max())
    return dict(rtol=0.0, atol=4 * 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7))


def _planted_tail(gen, b, h, g, s_q, s_k, hd, dev):
    """q, k, v whose softmax puts nearly all of every query's mass on the
    last S_k mod 64 keys (``chip_smoke.planted_tail``): q on a direction u of
    its KV head, the keys before the tail on -1.5 u, the tail's near 0."""
    tail, kv = s_k % 64 or 64, h // g
    u = torch.randn(b, kv, 1, hd, generator=gen, device=dev)
    u = u * (hd ** 0.5 / u.norm(dim=-1, keepdim=True))
    q = u.repeat_interleave(g, dim=1) + 0.1 * torch.randn(b, h, s_q, hd, generator=gen, device=dev)
    k = -1.5 * u + 0.1 * torch.randn(b, kv, s_k, hd, generator=gen, device=dev)
    k[:, :, s_k - tail:] = 0.1 * torch.randn(b, kv, tail, hd, generator=gen, device=dev)
    return tail, q, k, torch.randn(b, kv, s_k, hd, generator=gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [False, True], ids=["random", "planted_tail"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,g,s_q,s_k,hd",
    [(2, 12, 1, 1500, 1500, 64),  # whisper's encoder, bidirectional
     (2, 12, 1, 64, 1500, 64), (2, 12, 1, 1, 1500, 64),  # whisper's cross
     (1, 32, 4, 512, 1601, 128), (2, 32, 4, 64, 1601, 128), (1, 32, 4, 1, 1601, 128)],  # the vlm's
)
def test_cuda_flash_attention_bidirectional_and_cross(cuda, dtype, b, h, g, s_q, s_k, hd, planted):
    """Kernel 7 non-causal at whisper's and the vlm's shapes (S_k = 1500 =
    23 * 64 + 28 and 1601 = 25 * 64 + 1: ragged tails), on the tensor cores
    in bf16 (to 4 ulps of the largest output) and the CUDA cores in f32,
    against the plain version, on random inputs and on inputs whose mass
    lies in the tail tile (a kernel dropping or mis-masking it misses by
    about |v|); then the gradients through the wrapper (kernel forward,
    ``attention_backward``) against the CPU's in f32."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(s_q + s_k)
    if planted:
        tail, q, k, v = _planted_tail(gen, b, h, g, s_q, s_k, hd, cuda)
        q, k, v = (t.to(dt) for t in (q, k, v))
        scores = q.float() @ k.float().repeat_interleave(g, dim=1).transpose(-1, -2) * hd ** -0.5
        assert float(torch.softmax(scores, dim=-1)[..., s_k - tail:].sum(-1).min()) >= 0.99
    else:
        q = torch.randn(b, h, s_q, hd, generator=gen, device=cuda).to(dt)
        k, v = (torch.randn(b, h // g, s_k, hd, generator=gen, device=cuda).to(dt) for _ in range(2))
    before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v, causal=False, q_groups=g)
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.launches_tc == before_tc + int(dtype == "bf16")
    want = ref.mha_reference(q, k, v, causal=False, q_groups=g)
    tol = _bf16_out_tol(want) if dtype == "bf16" else dict(rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got, want, **tol)
    if planted:
        cut = s_k - tail
        dropped = ref.mha_reference(q, k[:, :, :cut], v[:, :, :cut], causal=False, q_groups=g)
        assert float((dropped.float() - want.float()).abs().max()) > 10 * tol["atol"]
    if dtype == "bf16":
        return
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(
        fa.flash_attention(*leaves, causal=False, q_groups=g).square().sum(), leaves)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    want_g = torch.autograd.grad(
        fa.flash_attention(*cpu, causal=False, q_groups=g).square().sum(), cpu)
    for a, w in zip(grads, want_g, strict=True):
        torch.testing.assert_close(a.cpu(), w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm"])
def test_kernel_backwards_run_unrecorded_under_func_grad(name, monkeypatch):
    """Under ``vmap(grad(...))``, the zoo round's transform, the PyTorch
    backwards of kernels 7 and 6 run with grad mode off.  ``torch.func.grad``
    differentiates with ``create_graph``, so a recorded backward would keep
    every layer's f32 intermediates alive until the whole backward ends:
    whisper's round at C = 8 ran out of the card's 80 GB on its encoder's
    (16, 12, 1500, 1500) attention probabilities that way.  Nor do they go
    through ``_common._FirstOrder``, whose result would make the backward
    ops after it record."""
    from repro_torch.kernels import _common
    from repro_torch.kernels import rmsnorm as rms

    wrapped = []
    monkeypatch.setattr(_common._FirstOrder, "apply", lambda *a: wrapped.append(a))
    seen = []
    if name == "flash_attention":
        inner = fa.attention_backward

        def spy(*a, **kw):
            seen.append(torch.is_grad_enabled())
            return inner(*a, **kw)

        monkeypatch.setattr(fa, "attention_backward", spy)

        def f(q, k):
            return fa.flash_attention(q, k, k, causal=False, q_groups=2).square().sum()

        args = (torch.randn(3, 4, 5, 16), torch.randn(2, 9, 16))
    else:
        inner = torch.rsqrt

        def spy(*a, **kw):
            seen.append(torch.is_grad_enabled())
            return inner(*a, **kw)

        monkeypatch.setattr(torch, "rsqrt", spy)

        def f(x, s):
            return rms.rmsnorm(x, s).square().sum()

        args = (torch.randn(3, 6, 8), torch.randn(8))
    g = torch.func.vmap(torch.func.grad(f), in_dims=(0, None))(*args)
    assert g.shape == args[0].shape and bool(torch.isfinite(g).all())
    assert seen and seen[-1] is False
    assert not wrapped


@pytest.mark.parametrize("how", ["grad_of_grad", "create_graph"])
@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm"])
def test_kernel_backwards_refuse_second_order(name, how):
    """The PyTorch backwards of kernels 7 and 6 run unrecorded, so a
    second-order gradient through them would miss their term: it raises
    instead, under nested ``torch.func.grad`` and under ``create_graph``
    followed by a second ``backward``."""
    from repro_torch.kernels import rmsnorm as rms

    if name == "flash_attention":
        def f(x):
            return fa.flash_attention(x, x[:2], x[:2], causal=False, q_groups=2).square().sum()

        x = torch.randn(4, 5, 16)
    else:
        def f(x):
            return rms.rmsnorm(x, x[0]).square().sum()

        x = torch.randn(6, 8)
    assert bool(torch.isfinite(torch.func.grad(f)(x)).all())  # first order runs
    with pytest.raises(RuntimeError, match="first-order only"):
        if how == "grad_of_grad":
            torch.func.grad(lambda y: torch.func.grad(f)(y).sum())(x)
        else:
            y = x.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(f(y), y, create_graph=True)
            g.sum().backward()
