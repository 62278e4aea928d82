"""The port's dense zoo models against the JAX reference on the CPU.

The same weights (the reference's ``init_params`` tree carried across with
``params_from_reference``) and the same tokens go through
``repro.models.transformer`` and ``repro_torch.models.transformer``:
``forward`` logits, ``prefill`` logits and three paged ``decode_step``s must
agree in f32 for reduced smollm-360m, llama3.2-1b-sw (every layer
sliding-window) and gemma2-27b (local/global pattern, attention and final
softcaps, embedding scaling, tanh-gelu).  The port's attention runs its
kernel 7 plain version, the reference its einsum ``_sdpa``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs.llama3_2_1b import SW_CONFIG as REF_SW_CONFIG  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config, has_arch, list_archs  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402

# f32 throughout; the two frameworks sum in other orders (XLA vs ATen) and
# compute exp/tanh/rsqrt with other polynomials: a few ulps per op, two to
# four layers deep.  atol covers logits near 0.
TOL = dict(rtol=1e-4, atol=1e-5)

# (name, reduced overrides): windows of 8 bind at these sequence lengths.
ARCHS = {
    "smollm-360m": dict(n_layers=2, d_model=64, d_ff=128, vocab=64),
    "llama3.2-1b-sw": dict(n_layers=2, d_model=64, d_ff=128, vocab=64, sliding_window=8),
    "gemma2-27b": dict(vocab=64, sliding_window=8),
}


def _ref_cfg(name):
    base = REF_SW_CONFIG if name == "llama3.2-1b-sw" else ref_get_config(name)
    return base.reduced(**ARCHS[name])


def _cfg(name):
    return get_config(name).reduced(**ARCHS[name])


def _weights(name, seed=0):
    """The reference's weights, in both frameworks."""
    ref_cfg = _ref_cfg(name)
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_cfg, ref_params, _cfg(name), transformer.params_from_reference(np_params, _cfg(name), "cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize(
    "name",
    ["smollm-360m", "llama3.2-1b", "llama3.2-1b-sw", "gemma2-27b", "llama3-405b", "zamba2-1.2b",
     "qwen3-moe-235b-a22b", "arctic-480b", "xlstm-125m"],
)
def test_configs_match_reference(name):
    """The port's own copies of the dense, hybrid, moe and xlstm configs
    equal the reference's, field for field (param_dtype as the torch dtype
    of the same name)."""
    ref = REF_SW_CONFIG if name == "llama3.2-1b-sw" else ref_get_config(name)
    port = get_config(name)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "param_dtype":
            assert str(b).removeprefix("torch.") == jnp.dtype(a).name
        else:
            assert a == b, f"{name}.{f.name}: {a!r} != {b!r}"
    assert port.reduced().param_dtype == torch.float32


def test_registry_lists_every_arch_and_refuses_unported_families():
    """Every arch of the reference is registered, the vlm and audio ones
    included (no family is left unported: the registry returns their
    configs, held field for field in tests/test_torch_frontends.py); an
    unknown name raises."""
    assert list_archs() == ref_list_archs()
    assert all(has_arch(a) for a in ref_list_archs()) and not has_arch("nope")
    for arch, family in (("whisper-small", "audio"), ("llama-3.2-vision-11b", "vlm")):
        cfg = get_config(arch)
        assert (cfg.name, cfg.family) == (arch, family) and cfg.frontend
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("nope")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_prefill_decode_match_reference(name):
    ref_cfg, ref_params, cfg, params = _weights(name)
    b, s, extra = 2, 13, 3
    tokens = _tokens(cfg, (b, s + extra))

    ref_logits, _ = ref_tf.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    logits, aux = transformer.forward(params, cfg, torch.from_numpy(tokens))
    assert logits.shape == (b, s + extra, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL, err_msg=f"{name}: forward")

    ref_pre, ref_caches = ref_tf.prefill(
        ref_params, ref_cfg, jnp.asarray(tokens[:, :s]), max_seq=s + extra + 1, page_size=4
    )
    pre, caches = transformer.prefill(
        params, cfg, torch.from_numpy(tokens[:, :s]), max_seq=s + extra + 1, page_size=4
    )
    np.testing.assert_allclose(_np(pre), _np(ref_pre), **TOL, err_msg=f"{name}: prefill")
    for j, (c, rc) in enumerate(zip(caches, ref_caches)):
        np.testing.assert_array_equal(c["page_table"].numpy(), np.asarray(rc["page_table"]))
        np.testing.assert_allclose(_np(c["pool_k"]), _np(rc["pool_k"]), **TOL, err_msg=f"slot {j} K")
    for i in range(extra):
        tok = tokens[:, s + i : s + i + 1]
        ref_dec, ref_caches = ref_tf.decode_step(
            ref_params, ref_cfg, jnp.asarray(tok), ref_caches, jnp.asarray(s + i, jnp.int32)
        )
        dec, caches = transformer.decode_step(params, cfg, torch.from_numpy(tok), caches, s + i)
        np.testing.assert_allclose(_np(dec), _np(ref_dec), **TOL, err_msg=f"{name}: decode {i}")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_paged_prefill_decode_matches_forward(name):
    """Teacher forcing within the port: prefill + paged decode agree with the
    full forward (tests/test_serve.py's check)."""
    _, _, cfg, params = _weights(name, seed=3)
    b, s, extra = 2, 12, 3
    tokens = torch.from_numpy(_tokens(cfg, (b, s + extra), seed=3))
    full, _ = transformer.forward(params, cfg, tokens)
    pre, caches = transformer.prefill(params, cfg, tokens[:, :s], max_seq=s + extra + 1, page_size=4)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, s - 1]), **TOL)
    for i in range(extra):
        dec, caches = transformer.decode_step(params, cfg, tokens[:, s + i : s + i + 1], caches, s + i)
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, s + i]), **TOL, err_msg=f"step {i}")


def test_dense_decode_cache_matches_reference():
    """The unpaged decode layout (``init_caches`` without ``page_size``),
    filled by prefill into ``max_seq``-long caches."""
    ref_cfg, ref_params, cfg, params = _weights("smollm-360m")
    tokens = _tokens(cfg, (2, 10))
    _, ref_caches = ref_tf.prefill(ref_params, ref_cfg, jnp.asarray(tokens[:, :8]), max_seq=12)
    _, caches = transformer.prefill(params, cfg, torch.from_numpy(tokens[:, :8]), max_seq=12)
    assert tuple(caches[0]["k"].shape) == tuple(ref_caches[0]["k"].shape)
    for i in range(2):
        tok = tokens[:, 8 + i : 9 + i]
        ref_dec, ref_caches = ref_tf.decode_step(
            ref_params, ref_cfg, jnp.asarray(tok), ref_caches, jnp.asarray(8 + i, jnp.int32)
        )
        dec, caches = transformer.decode_step(params, cfg, torch.from_numpy(tok), caches, 8 + i)
        np.testing.assert_allclose(_np(dec), _np(ref_dec), **TOL)
    zeros = transformer.init_caches(cfg, 2, 12, device="cpu")
    ref_zeros = ref_tf.init_caches(ref_cfg, 2, 12)
    assert [tuple(c["k"].shape) for c in zeros] == [tuple(c["k"].shape) for c in ref_zeros]
    paged = transformer.init_caches(cfg, 2, 12, page_size=4, device="cpu")
    ref_paged = ref_tf.init_caches(ref_cfg, 2, 12, page_size=4)
    np.testing.assert_array_equal(paged[0]["page_table"].numpy(), np.asarray(ref_paged[0]["page_table"]))


@pytest.mark.parametrize("name", ["smollm-360m", "gemma2-27b"])
def test_loss_matches_reference(name):
    ref_cfg, ref_params, cfg, params = _weights(name)
    tokens, targets = _tokens(cfg, (2, 9), seed=5), _tokens(cfg, (2, 9), seed=6)
    want = ref_tf.loss_fn(ref_params, ref_cfg, (jnp.asarray(tokens), jnp.asarray(targets)))
    got = transformer.loss_fn(params, cfg, (torch.from_numpy(tokens), torch.from_numpy(targets)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_params_from_reference_bf16_and_checks():
    """bf16 leaves (ml_dtypes in numpy) arrive bit for bit; a tree that is
    not the config's raises."""
    ref_cfg = ref_get_config("smollm-360m").reduced(n_layers=2, d_model=64, d_ff=128, vocab=64,
                                                    param_dtype=jnp.bfloat16)
    cfg = get_config("smollm-360m").reduced(n_layers=2, d_model=64, d_ff=128, vocab=64,
                                            param_dtype=torch.bfloat16)
    np_params = jax.tree_util.tree_map(np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    params = transformer.params_from_reference(np_params, cfg, "cpu")
    wq = params["stacks"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and tuple(wq.shape) == (2, 64, 64)
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(), np_params["stacks"][0]["attn"]["wq"].view(np.int16)
    )
    assert transformer.param_count(params) == ref_tf.param_count(np_params)
    bad = dict(np_params, rogue=np.zeros(3))
    with pytest.raises(ValueError, match="rogue"):
        transformer.params_from_reference(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="expected"):
        transformer.params_from_reference(np_params, _cfg("smollm-360m"), "cpu")  # f32 config


def test_kernel_calls_per_prefill_and_decode(monkeypatch):
    """The launch counts the GPU path must show: kernel 6 ``2 * n_layers +
    1`` times per prefill and per decode step, kernel 7 ``n_layers`` times
    per prefill and never in decode (counted here at the ops wrappers)."""
    from repro_torch.kernels import ops

    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ops, "rmsnorm", counted("rmsnorm", ops.rmsnorm))
    monkeypatch.setattr(ops, "flash_attention", counted("flash_attention", ops.flash_attention))
    cfg = get_config("gemma2-27b").reduced(vocab=64, n_layers=4)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 6), dtype=torch.int64)
    _, caches = transformer.prefill(params, cfg, tokens, max_seq=8, page_size=4)
    assert calls == {"rmsnorm": 2 * 4 + 1, "flash_attention": 4}
    transformer.decode_step(params, cfg, tokens[:, :1], caches, 6)
    assert calls == {"rmsnorm": 2 * (2 * 4 + 1), "flash_attention": 4}


def test_unported_block_kinds_and_cross_attention_raise():
    """An unknown block kind raises ``ValueError`` (``enc`` blocks live in
    whisper's encoder alone, never in a pattern); ``cross_attention``, once
    refused, runs: x (2, 5, d) over a source of 7 positions."""
    for kind in ("nope", "enc"):
        cfg = get_config("smollm-360m").reduced(block_pattern=(kind,))
        with pytest.raises(ValueError, match="unknown block kind"):
            transformer.init_params(cfg, torch.Generator(), "cpu")
    from repro_torch.models import attention

    cfg = get_config("smollm-360m").reduced(d_model=64)
    gen = torch.Generator().manual_seed(0)
    p = attention.init_attention(cfg, gen, cross=True)
    out = attention.cross_attention(p, cfg, torch.randn(2, 5, 64, generator=gen),
                                    torch.randn(2, 7, 64, generator=gen))
    assert out.shape == (2, 5, 64) and bool(torch.isfinite(out).all())


def test_init_params_shapes_and_scales():
    """Fresh weights: the reference's tree, shapes and init ranges."""
    cfg = _cfg("gemma2-27b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_shapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape), jax.eval_shape(lambda: ref_tf.init_params(_ref_cfg("gemma2-27b"), jax.random.PRNGKey(0)))
    )
    got = jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
    assert got == ref_shapes
    assert float(params["embed"].abs().max()) <= 0.02
    wq = params["stacks"][0]["attn"]["wq"]
    assert 0.5 / np.sqrt(cfg.d_model) < float(wq.abs().max()) <= 1.0 / np.sqrt(cfg.d_model)
    assert float(params["stacks"][1]["ln1"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="unsupported device"):
        transformer.init_params(cfg, torch.Generator(), "meta")


@pytest.mark.parametrize("window", [None, 5])
def test_attention_matches_reference(window):
    """The public full-sequence ``attention`` (one block's projections, RoPE,
    kernel 7's plain version, ``wo``) against the reference's."""
    from repro.models import attention as ref_attention
    from repro_torch.models import attention

    ref_cfg, ref_params, cfg, params = _weights("gemma2-27b")
    x = np.random.default_rng(7).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    ref_blk = jax.tree_util.tree_map(lambda a: a[0], ref_params["stacks"][0]["attn"])
    blk = {k: v[0] for k, v in params["stacks"][0]["attn"].items()}
    want = ref_attention.attention(ref_blk, ref_cfg, jnp.asarray(x), window=window)
    got = attention.attention(blk, cfg, torch.from_numpy(x), window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_rope_and_softcap_match_reference():
    from repro.models import common as ref_common

    pos = np.arange(7)
    cos, sin = common.rope_angles(torch.from_numpy(pos), 16, 5e5)
    rcos, rsin = ref_common.rope_angles(jnp.asarray(pos), 16, 5e5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(0).standard_normal((1, 7, 2, 16)).astype(np.float32)
    got = common.apply_rope(torch.from_numpy(x), cos[None, :, None, :], sin[None, :, None, :])
    want = ref_common.apply_rope(jnp.asarray(x), rcos[None, :, None, :], rsin[None, :, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        common.softcap(torch.from_numpy(x) * 100, 30.0).numpy(),
        np.asarray(ref_common.softcap(jnp.asarray(x) * 100, 30.0)), rtol=1e-6, atol=1e-5,
    )
