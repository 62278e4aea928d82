"""The port's hybrid family (zamba2: ``mamba2`` and ``shared_attn`` blocks)
against the JAX reference on the CPU.

The same weights (the reference's ``init_params`` tree carried across with
``params_from_reference``) and the same tokens go through
``repro.models.transformer`` and ``repro_torch.models.transformer``:
``forward`` logits, ``prefill`` logits and caches, and three paged
``decode_step``s agree in f32 (rtol 1e-4, atol 1e-5: the two frameworks sum
in other orders and compute exp, softplus and rsqrt with other
polynomials, a few ulps an op, up to 19 blocks deep).  Two configs:
tests/test_serve.py's reduced hybrid (``SERVE_ARCHS["ssm"]``: 4 layers, one
(mamba2, mamba2, mamba2, shared_attn) group, vocab 64) and zamba2's own
``reduced()`` (its 19-slot pattern, one group).  The serving engine's greedy
tokens, and its sampled tokens on the reference engine's replayed Gumbel
noise, equal ``repro.serve.ServeEngine``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.rng import ReplaySource  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = {
    "serve-ssm": dict(n_layers=4, block_pattern=("mamba2", "mamba2", "mamba2", "shared_attn"),
                      vocab=64),
    "zamba2-reduced": {},
}

# One warm-up call: the first multithreaded torch.exp of a process is
# sometimes off by ~1.5e-4 relative in torch's CPU build
# (tests/test_torch_cold_exp.py shows it with torch and numpy alone).
torch.exp(torch.zeros(1 << 16))


def _ref_cfg(name):
    return ref_get_config("zamba2-1.2b").reduced(**ARCHS[name])


def _cfg(name):
    return get_config("zamba2-1.2b").reduced(**ARCHS[name])


def _weights(name, seed=0):
    """The reference's weights, in both frameworks."""
    ref_params = ref_tf.init_params(_ref_cfg(name), jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_params, transformer.params_from_reference(np_params, _cfg(name), "cpu")


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


def _check_caches(caches, ref_caches, cfg, what):
    for j, (kind, c, rc) in enumerate(zip(cfg.block_pattern, caches, ref_caches)):
        if kind == "mamba2":
            for k in ("conv", "ssm"):
                np.testing.assert_allclose(_np(c[k]), _np(rc[k]), **TOL, err_msg=f"{what} slot {j} {k}")
        else:
            np.testing.assert_array_equal(c["page_table"].numpy(), np.asarray(rc["page_table"]))
            for k in ("pool_k", "pool_v"):
                np.testing.assert_allclose(_np(c[k]), _np(rc[k]), **TOL, err_msg=f"{what} slot {j} {k}")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_prefill_decode_match_reference(name):
    """S = 13 (the model's chunk rule gives one 13-step chunk), page size 4,
    three paged decode steps; caches compared after prefill and after the
    last step."""
    ref_params, params = _weights(name)
    ref_cfg, cfg = _ref_cfg(name), _cfg(name)
    b, s, extra = 2, 13, 3
    tokens = _tokens(cfg.vocab, (b, s + extra))

    ref_logits, _ = ref_tf.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    logits, aux = transformer.forward(params, cfg, torch.from_numpy(tokens))
    assert logits.shape == (b, s + extra, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL, err_msg=f"{name}: forward")

    kw = dict(max_seq=s + extra + 1, page_size=4)
    ref_pre, ref_caches = ref_tf.prefill(ref_params, ref_cfg, jnp.asarray(tokens[:, :s]), **kw)
    pre, caches = transformer.prefill(params, cfg, torch.from_numpy(tokens[:, :s]), **kw)
    np.testing.assert_allclose(_np(pre), _np(ref_pre), **TOL, err_msg=f"{name}: prefill")
    _check_caches(caches, ref_caches, cfg, "prefill")
    for i in range(extra):
        tok = tokens[:, s + i : s + i + 1]
        ref_dec, ref_caches = ref_tf.decode_step(
            ref_params, ref_cfg, jnp.asarray(tok), ref_caches, jnp.asarray(s + i, jnp.int32)
        )
        dec, caches = transformer.decode_step(params, cfg, torch.from_numpy(tok), caches, s + i)
        np.testing.assert_allclose(_np(dec), _np(ref_dec), **TOL, err_msg=f"{name}: decode {i}")
    _check_caches(caches, ref_caches, cfg, "decode")


@pytest.mark.parametrize("name,s", [("serve-ssm", 12), ("serve-ssm", 32), ("zamba2-reduced", 16)])
def test_paged_prefill_decode_matches_forward(name, s):
    """Teacher forcing within the port (tests/test_serve.py's check):
    prefill + paged decode agree with the full forward, the Mamba2 state
    handed from the chunked scan to the one-token recurrence."""
    _, params = _weights(name, seed=3)
    cfg = _cfg(name)
    extra = 3
    tokens = torch.from_numpy(_tokens(cfg.vocab, (2, s + extra), seed=3))
    full, _ = transformer.forward(params, cfg, tokens)
    pre, caches = transformer.prefill(params, cfg, tokens[:, :s], max_seq=s + extra + 1, page_size=4)
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, s - 1]), **TOL)
    for i in range(extra):
        dec, caches = transformer.decode_step(params, cfg, tokens[:, s + i : s + i + 1], caches, s + i)
        np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, s + i]), **TOL, err_msg=f"step {i}")


def test_params_from_reference_stores_the_shared_block_once():
    """The ``shared_attn`` slot holds no weights; the one attention block
    lives unstacked in ``params["shared"]``; every leaf keeps its dtype
    (the f32 a_log, d_skip, dt_bias in a bf16 model) and its bits."""
    ref_cfg = ref_get_config("zamba2-1.2b").reduced(param_dtype=jnp.bfloat16, **ARCHS["serve-ssm"])
    cfg = get_config("zamba2-1.2b").reduced(param_dtype=torch.bfloat16, **ARCHS["serve-ssm"])
    np_params = jax.tree_util.tree_map(np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    params = transformer.params_from_reference(np_params, cfg, "cpu")
    assert params["stacks"][3] == {} and np_params["stacks"][3] == {}
    wq = params["shared"]["attn"]["wq"]
    assert tuple(wq.shape) == (cfg.d_model, cfg.n_heads * cfg.hd) and wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(), np_params["shared"]["attn"]["wq"].view(np.int16))
    mamba = params["stacks"][0]["ssm"]
    assert mamba["in_proj"].dtype == torch.bfloat16 and mamba["in_proj"].shape[0] == 1
    for k in ("a_log", "d_skip", "dt_bias"):
        assert mamba[k].dtype == torch.float32
    assert transformer.param_count(params) == ref_tf.param_count(np_params)
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)), fresh) == \
        jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)), params)
    with pytest.raises(ValueError, match="expected"):
        transformer.params_from_reference({k: v for k, v in np_params.items() if k != "shared"}, cfg, "cpu")


def test_full_size_tree_matches_reference():
    """zamba2-1.2b at full width and depth: the reference's tree (shapes from
    ``jax.eval_shape``, nothing allocated) and 1,053,612,800 parameters."""
    cfg = get_config("zamba2-1.2b")
    ref_shapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape),
        jax.eval_shape(lambda: ref_tf.init_params(ref_get_config("zamba2-1.2b"), jax.random.PRNGKey(0))),
    )
    tree = transformer._init_tree(cfg, None)  # shapes only, on the meta device
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), tree) == ref_shapes
    assert transformer.param_count(tree) == 1_053_612_800
    assert (cfg.n_layers, len(cfg.block_pattern), cfg.pattern_repeats()) == (38, 19, 2)


def test_init_caches_match_reference():
    """Zero caches: K/V (paged or dense) for the shared attention, the Mamba2
    {conv f32, ssm f32} state, never paged; prefill's caches have the
    reference's shapes and dtypes too."""
    cfg, ref_cfg = _cfg("serve-ssm"), _ref_cfg("serve-ssm")
    for page_size in (None, 4):
        got = transformer.init_caches(cfg, 2, 12, page_size=page_size, device="cpu")
        want = ref_tf.init_caches(ref_cfg, 2, 12, page_size=page_size)
        assert jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")), got) \
            == jax.tree_util.tree_map(lambda x: (tuple(x.shape), x.dtype.name), want)
    assert "page_table" not in got[0] and "page_table" in got[3]


def test_decode_updates_recurrent_caches_in_place():
    """The engine's caches keep their addresses: a decode step writes the
    Mamba2 conv and SSM states into the stacked cache tensors."""
    _, params = _weights("serve-ssm")
    cfg = _cfg("serve-ssm")
    tokens = torch.from_numpy(_tokens(cfg.vocab, (2, 9)))
    _, caches = transformer.prefill(params, cfg, tokens[:, :8], max_seq=12, page_size=4)
    ptrs = [(c["conv"].data_ptr(), c["ssm"].data_ptr()) for c in caches[:3]]
    before = [c["ssm"].clone() for c in caches[:3]]
    _, out = transformer.decode_step(params, cfg, tokens[:, 8:9], caches, 8)
    assert out is caches
    assert [(c["conv"].data_ptr(), c["ssm"].data_ptr()) for c in caches[:3]] == ptrs
    assert all(not torch.equal(c["ssm"], b) for c, b in zip(caches[:3], before))


def test_kernel_calls_per_prefill_and_decode(monkeypatch):
    """The launch counts the GPU path must show, counted at the ops
    wrappers: per prefill kernel 8 once a mamba2 block, kernel 7 once a
    shared_attn invocation, kernel 6 twice a block plus the final norm; a
    decode step kernel 6 as often and kernels 7 and 8 never."""
    from repro_torch.kernels import ops

    calls = {"rmsnorm": 0, "flash_attention": 0, "ssd_scan": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    cfg = get_config("zamba2-1.2b").reduced(**{**ARCHS["serve-ssm"], "n_layers": 8})
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 6), dtype=torch.int64)
    _, caches = transformer.prefill(params, cfg, tokens, max_seq=8, page_size=4)
    assert calls == {"rmsnorm": 2 * 8 + 1, "flash_attention": 2, "ssd_scan": 6}
    transformer.decode_step(params, cfg, tokens[:, :1], caches, 6)
    assert calls == {"rmsnorm": 2 * (2 * 8 + 1), "flash_attention": 2, "ssd_scan": 6}


def _engines(temperature=0.0, seed=0, steps=6, random_source=None):
    ref_params, params = _weights("serve-ssm")
    prompts = _tokens(64, (2, 8), seed=2)
    ref = RefEngine(_ref_cfg("serve-ssm"), ref_params, batch=2, max_seq=32, page_size=8,
                    temperature=temperature, seed=seed)
    ref.start(jnp.asarray(prompts))
    ref.step(steps)
    eng = ServeEngine(_cfg("serve-ssm"), params, batch=2, max_seq=32, page_size=8,
                      temperature=temperature, seed=seed, device="cpu", random_source=random_source)
    eng.start(torch.from_numpy(prompts))
    eng.step(steps)
    return ref, eng


def test_engine_greedy_tokens_match_reference_engine():
    ref, eng = _engines()
    np.testing.assert_array_equal(eng.generated().numpy(), np.asarray(ref.generated()))
    assert eng.index == ref.index == 14


def test_engine_sampled_tokens_match_reference_on_replayed_noise():
    """Temperature 0.8: the port fed the reference engine's Gumbel noise
    (PRNGKey(seed), one split per engine call) samples its tokens."""
    seed, steps = 3, 6
    key, noise = jax.random.PRNGKey(seed), []
    for _ in range(steps + 1):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(sub, (2, 64), jnp.float32)))
    ref, eng = _engines(temperature=0.8, seed=seed, steps=steps,
                        random_source=ReplaySource(gumbel=np.stack(noise), device="cpu"))
    np.testing.assert_array_equal(eng.generated().numpy(), np.asarray(ref.generated()))


def test_launcher_serves_the_hybrid_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "3"])
    assert tuple(out["engine"].generated().shape) == (2, 3)
    assert out["engine"].cfg.family == "hybrid"
    assert not any(out["launches"].values())  # the CPU runs the plain versions
    printed = capsys.readouterr().out
    assert "prefill" in printed and "tok/s" in printed and "generated ids" in printed
