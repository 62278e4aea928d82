"""The port's serving engine and demo launcher against the JAX reference on
the CPU (after tests/test_serve.py's engine tests).

The same weights (``params_from_reference``) and prompts go through
``repro.serve.ServeEngine`` and ``repro_torch.serve.ServeEngine``; greedy
tokens must be equal, and so must sampled tokens when the port replays the
reference engine's Gumbel noise (``jax.random.categorical`` samples
``argmax(logits + gumbel)``, with one key split per engine call).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.rng import PhiloxSource, ReplaySource  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab=64)


def _tiny():
    return get_config("smollm-360m").reduced(**TINY)


def _ref_tiny():
    return ref_get_config("smollm-360m").reduced(**TINY)


def _params(seed=0):
    """The reference's weights for the tiny config, in both frameworks."""
    ref_params = ref_tf.init_params(_ref_tiny(), jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_params, transformer.params_from_reference(np_params, _tiny(), "cpu")


def _engine(params, *, seed=0, temperature=0.0, batch=2, max_seq=32, **kw):
    return ServeEngine(
        _tiny(), params, batch=batch, max_seq=max_seq, page_size=8,
        temperature=temperature, seed=seed, device="cpu", **kw,
    )


def _prompts(shape, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab"], shape).astype(np.int32)


def test_greedy_tokens_match_reference_engine():
    ref_params, params = _params()
    prompts = _prompts((2, 8))
    ref = RefEngine(_ref_tiny(), ref_params, batch=2, max_seq=32, page_size=8)
    ref.start(jnp.asarray(prompts))
    ref.step(8)
    eng = _engine(params)
    first = eng.start(torch.from_numpy(prompts))
    assert first.shape == (2, 1) and first.dtype == torch.int32
    assert eng.step(8) == 8
    np.testing.assert_array_equal(eng.generated().numpy(), np.asarray(ref.generated()))
    assert eng.index == ref.index == 16
    assert eng.last_logits.shape == (2, 1, TINY["vocab"])


def test_sampled_tokens_match_reference_engine_on_replayed_noise():
    """Temperature 0.8: the port fed the reference engine's Gumbel noise
    (its key chain: PRNGKey(seed), one split per call) samples its tokens."""
    ref_params, params = _params()
    prompts = _prompts((2, 8), seed=2)
    seed, steps, temp = 3, 6, 0.8
    ref = RefEngine(_ref_tiny(), ref_params, batch=2, max_seq=32, page_size=8,
                    temperature=temp, seed=seed)
    ref.start(jnp.asarray(prompts))
    ref.step(steps)
    key, noise = jax.random.PRNGKey(seed), []
    for _ in range(steps + 1):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(sub, (2, TINY["vocab"]), jnp.float32)))
    eng = _engine(params, temperature=temp,
                  random_source=ReplaySource(gumbel=np.stack(noise), device="cpu"))
    eng.start(torch.from_numpy(prompts))
    eng.step(steps)
    np.testing.assert_array_equal(eng.generated().numpy(), np.asarray(ref.generated()))


def test_swap_rejects_treedef_and_aval_drift():
    _, params = _params()
    eng = _engine(params)
    with pytest.raises(ValueError, match="treedef"):
        eng.swap_params(dict(params, rogue=torch.zeros(3)))
    drift = dict(params, embed=params["embed"].to(torch.float16))
    with pytest.raises(ValueError, match="aval drift.*embed"):
        eng.swap_params(drift)
    shape = dict(params, final_norm=torch.zeros(3))
    with pytest.raises(ValueError, match="aval drift.*final_norm"):
        eng.swap_params(shape)
    assert eng.swaps == 0  # rejected candidates never count
    # The same names in another order are the same signature.
    eng.swap_params({k: params[k] for k in reversed(list(params))})
    assert eng.swaps == 1


def test_hot_swap_keeps_in_flight_state_and_storage():
    """A mid-generation swap changes later tokens, keeps the in-flight cache
    and position, and copies into the pinned storage in place."""
    _, params = _params(0)
    _, variant = _params(1)
    prompts = torch.from_numpy(_prompts((2, 8), seed=5))
    ref = _engine(params)
    ref.start(prompts)
    ref.step(8)

    eng = _engine(params)
    ptrs = [t.data_ptr() for t in tree_leaves(eng.params)]
    eng.start(prompts)
    eng.step(4)
    eng.swap_params(variant)
    eng.step(4)
    gen_ref, gen = ref.generated().numpy(), eng.generated().numpy()
    np.testing.assert_array_equal(gen[:, :5], gen_ref[:, :5])
    assert not np.array_equal(gen[:, 5:], gen_ref[:, 5:])
    assert eng.swaps == 1 and eng.index == ref.index == 16
    assert [t.data_ptr() for t in tree_leaves(eng.params)] == ptrs
    torch.testing.assert_close(eng.params["embed"], variant["embed"], rtol=0, atol=0)
    # The engine copied its weights: the caller's tensors are untouched.
    assert not torch.equal(params["embed"], variant["embed"])


def test_step_is_capacity_bounded():
    _, params = _params()
    eng = _engine(params)
    eng.start(torch.zeros((2, 28), dtype=torch.int64))
    assert eng.capacity == 4
    assert eng.step(100) == 4  # clipped to the paged cache's room
    assert eng.step(1) == 0
    assert tuple(eng.generated().shape) == (2, 5)  # first token + 4 decode steps
    assert eng.decode_tokens == 8 and eng.tokens_per_sec() > 0


def test_temperature_zero_is_deterministic_across_seeds():
    _, params = _params()
    prompts = torch.from_numpy(_prompts((2, 8)))
    outs = []
    for seed in (0, 1):
        eng = _engine(params, seed=seed, temperature=0.0)
        eng.start(prompts)
        eng.step(6)
        outs.append(eng.generated().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_temperature_affects_first_token_and_seeds_diverge():
    _, params = _params()
    prompts = torch.from_numpy(_prompts((4, 8)))
    first_greedy = _engine(params, batch=4).start(prompts).numpy()
    firsts = []
    for seed in (0, 1, 2):
        eng = _engine(params, batch=4, seed=seed, temperature=5.0)
        eng.start(prompts)
        eng.step(6)
        firsts.append(eng.generated().numpy())
    assert any(not np.array_equal(f[:, :1], first_greedy) for f in firsts)
    assert not np.array_equal(firsts[0], firsts[1])
    assert not np.array_equal(firsts[1], firsts[2])


def test_engine_rejects_frontend_archs_and_bad_prompts():
    _, params = _params()
    with pytest.raises(ValueError, match="frontend"):
        ServeEngine(dataclasses.replace(_tiny(), frontend="vision"), params, batch=2,
                    max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        _engine(params, max_seq=1)
    eng = _engine(params)
    with pytest.raises(ValueError, match="prompts"):
        eng.start(torch.zeros((3, 8), dtype=torch.int64))  # wrong batch
    with pytest.raises(ValueError, match="decode room"):
        eng.start(torch.zeros((2, 32), dtype=torch.int64))  # no capacity left
    with pytest.raises(RuntimeError, match="start"):
        _engine(params).step()


def test_engine_and_launcher_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, params = _params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(_tiny(), params, batch=2, max_seq=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--reduced"])


def test_launch_serve_demo_on_cpu(capsys):
    out = launch_serve.main([
        "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
        "--new-tokens", "8", "--temperature", "0.8",
    ])
    eng = out["engine"]
    gen = eng.generated()
    assert tuple(gen.shape) == (2, 8) and int(gen.min()) >= 0 and int(gen.max()) < eng.cfg.vocab
    assert eng.index == 16 + 7 and eng.cfg.name == "smollm-360m-reduced"
    assert bool(torch.isfinite(eng.last_logits).all())
    printed = capsys.readouterr().out
    assert "prefill 2x16" in printed and "tok/s" in printed and "generated ids" in printed
    # Same seed, same run.
    again = launch_serve.main([
        "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
        "--new-tokens", "8", "--temperature", "0.8",
    ])
    torch.testing.assert_close(again["engine"].generated(), gen, rtol=0, atol=0)


# The moe and xlstm families, reduced (the reference's serving set,
# tests/test_serve.py): qwen3 (q/k norm), arctic (dense residual), xLSTM.
FAMILIES = ["qwen3-moe-235b-a22b", "arctic-480b", "xlstm-125m"]


def _cache_ptrs(caches):
    return [t.data_ptr() for t in tree_leaves(caches)]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tokens_match_reference_engine(name):
    """Greedy tokens equal the reference engine's on the same weights, and
    every cache tensor (paged K/V or recurrent state) keeps its address
    from prefill to the last step."""
    ref_cfg = ref_get_config(name).reduced(vocab=64)
    cfg = get_config(name).reduced(vocab=64)
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = transformer.params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    prompts = _prompts((2, 8), seed=7)
    ref = RefEngine(ref_cfg, ref_params, batch=2, max_seq=32, page_size=8)
    ref.start(jnp.asarray(prompts))
    ref.step(8)
    eng = ServeEngine(cfg, params, batch=2, max_seq=32, page_size=8, device="cpu")
    eng.start(torch.from_numpy(prompts))
    ptrs = _cache_ptrs(eng._caches)
    assert eng.step(8) == 8
    np.testing.assert_array_equal(eng.generated().numpy(), np.asarray(ref.generated()))
    assert _cache_ptrs(eng._caches) == ptrs


@pytest.mark.parametrize("name", ["xlstm-125m", "qwen3-moe-235b-a22b"])
def test_launch_serve_families_on_cpu(name, capsys):
    out = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "16", "--new-tokens", "8"])
    eng = out["engine"]
    assert tuple(eng.generated().shape) == (2, 8) and eng.cfg.name == f"{name}-reduced"
    assert bool(torch.isfinite(eng.last_logits).all())
    assert "generated ids" in capsys.readouterr().out


def test_gumbel_stream_leaves_round_streams_alone():
    """The engine's sampling stream is seeded apart: drawing from it moves
    none of the federated round's streams."""
    a, b = PhiloxSource(4, "cpu"), PhiloxSource(4, "cpu")
    g = a.gumbel(0, (2, 5))
    assert g.shape == (2, 5) and bool(torch.isfinite(g).all())
    torch.testing.assert_close(a.isp_uniforms(0, 7), b.isp_uniforms(0, 7), rtol=0, atol=0)
    torch.testing.assert_close(b.gumbel(0, (2, 5)), g, rtol=0, atol=0)  # seeded: repeatable
    assert not torch.equal(PhiloxSource(5, "cpu").gumbel(0, (2, 5)), g)
    with pytest.raises(ValueError, match="Gumbel"):
        ReplaySource(device="cpu").gumbel(0, (2, 5))
