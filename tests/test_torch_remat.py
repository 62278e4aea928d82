"""The memory switches of the port on the CPU: ``cfg.remat`` (the pattern
groups of the decoder recomputed in the backward, the reference's
``jax.checkpoint`` of its scan body) and ``cfg.slstm_segment`` (the sLSTM
loop recomputed a segment at a time), both through
``repro_torch.models.remat.recompute``.

* ``remat="full"`` and ``"none"`` give bitwise-equal losses and gradients
  under ``vmap(grad)`` (the zoo round) and a plain ``backward()``, for
  reduced smollm-360m (dense), zamba2-1.2b (the
  hybrid, whose ``shared`` block takes a cotangent from every invocation),
  qwen3-moe (the MoE aux loss leaves the recomputed group as an output)
  and xlstm-125m; the backwards of kernels 6 and 7 inside the recompute
  stay unrecorded (no ``_common._FirstOrder``);
* with ``remat="full"`` the port's gradients equal ``jax.grad`` of the
  reference (``remat="full"`` too) at ``tests/test_torch_kernel_grads.py``'s
  model tolerance (which, with the configs' default, holds smollm and
  zamba2 the same way; ``tests/test_torch_moe.py`` and
  ``tests/test_torch_xlstm.py`` the moe and xlstm families);
* the recompute runs each decoder block's kernels once more, and the
  encoder and the final norm once, under ``grad`` without ``vmap``
  (cohort_sequential's transform; the count ``chip_smoke.py`` checks on the
  card), and costs nothing where no gradient is taken;
* ``slstm_segment > 0`` inside a zoo round (``build_round_step``, ``vmap``
  over the slots) equals ``slstm_segment = 0`` within f32 rounding, also
  nested in ``remat="full"``;
* a second-order gradient through a recompute equals one without.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed.round import RoundSpec, build_round_step  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402
from repro_torch.kernels import _common  # noqa: E402
from repro_torch.models import remat, transformer  # noqa: E402

# tests/test_torch_kernel_grads.py's whole-model tolerance against jax.grad.
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)

# The first multithreaded torch.exp of a process is sometimes off by ~1.5e-4
# relative in torch's CPU build (tests/test_torch_cold_exp.py).
torch.exp(torch.zeros(1 << 16))

CONFIGS = {
    "smollm-360m": dict(n_layers=2, d_model=64, d_ff=128, vocab=128),
    "zamba2-1.2b": dict(block_pattern=("mamba2", "mamba2", "mamba2", "shared_attn"),
                        n_layers=8, d_model=64, vocab=128),
    "qwen3-moe-235b-a22b": dict(n_layers=2, d_model=64, vocab=128),
    "xlstm-125m": dict(d_model=64, vocab=128),
}


def _setup(name, seed=1, c=2, s=12):
    cfg = get_config(name).reduced(**CONFIGS[name])
    gen = torch.Generator().manual_seed(seed)
    params = transformer.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab, (c, 2, s), generator=gen)
    targets = torch.randint(0, cfg.vocab, (c, 2, s), generator=gen)
    return cfg, params, tokens, targets


def _requiring(tree, leaves):
    if isinstance(tree, dict):
        return {k: _requiring(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_requiring(v, leaves) for v in tree]
    leaf = tree.detach().clone().requires_grad_()
    leaves.append(leaf)
    return leaf


def _both_ways(cfg, params, tokens, targets):
    """(loss, leaves of the gradient) under vmap(grad) over the slots and
    under backward() of slot 0."""

    def loss(p, t, y):
        return transformer.loss_fn(p, cfg, (t, y))

    g_v, l_v = torch.func.vmap(torch.func.grad_and_value(loss), in_dims=(None, 0, 0))(
        params, tokens, targets)
    leaves: list = []
    l_b = loss(_requiring(params, leaves), tokens[0], targets[0])
    l_b.backward()
    return [(l_v, tree_leaves(g_v)), (l_b.detach(), [x.grad for x in leaves])]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_full_equals_none_bitwise(name, monkeypatch):
    cfg, params, tokens, targets = _setup(name)
    assert cfg.remat == "full"  # every config's default, as in the reference
    applied = []
    inner = remat._Recompute.apply
    monkeypatch.setattr(remat._Recompute, "apply", lambda *a: applied.append(1) or inner(*a))
    monkeypatch.setattr(_common._FirstOrder, "apply", lambda *a: pytest.fail("recorded backward"))
    full = _both_ways(cfg, params, tokens, targets)
    assert len(applied) >= 2 * cfg.pattern_repeats()
    applied.clear()
    none = _both_ways(dataclasses.replace(cfg, remat="none"), params, tokens, targets)
    assert applied == []
    for how, (a, b) in zip(("vmap(grad)", "backward"), zip(full, none)):
        assert torch.equal(a[0], b[0]), how
        assert len(a[1]) == len(b[1])
        for i, (x, y) in enumerate(zip(a[1], b[1])):
            assert torch.equal(x, y), f"{how}: leaf {i} max diff {float((x - y).abs().max())}"


@pytest.mark.parametrize("name", ["smollm-360m"])
def test_remat_full_matches_reference_grad(name):
    """The reference differentiates its ``jax.checkpoint``-ed scan body, the
    port its recomputed groups, on the reference's own weights."""
    kw = CONFIGS[name]
    ref_cfg, cfg = ref_get_config(name).reduced(**kw), get_config(name).reduced(**kw)
    assert ref_cfg.remat == cfg.remat == "full"
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = transformer.params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(3)
    tokens, targets = (rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32) for _ in range(2))
    got, loss = torch.func.grad_and_value(transformer.loss_fn)(
        params, cfg, (torch.from_numpy(tokens), torch.from_numpy(targets)))
    want, want_loss = jax.jit(jax.value_and_grad(ref_tf.loss_fn), static_argnums=1)(
        ref_params, ref_cfg, (jnp.asarray(tokens), jnp.asarray(targets)))[::-1]
    np.testing.assert_allclose(float(loss), float(want_loss), **MODEL_TOL)
    got_leaves, want_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g_got, g_want in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), **MODEL_TOL)


def _count_calls(monkeypatch):
    """Calls of the forwards of kernels 6-8's Functions (on the CPU their
    plain versions), where the card launches the kernels."""
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    counts = {"rmsnorm": 0, "flash_attention": 0, "ssd_scan": 0}
    def spy(key, inner):
        def forward(*a):
            counts[key] += 1
            return inner(*a)

        return staticmethod(forward)

    for key, fn in (("rmsnorm", rmsnorm._RMSNorm), ("flash_attention", flash_attention._FlashAttention),
                    ("ssd_scan", ssd_scan._SSDScan)):
        monkeypatch.setattr(fn, "forward", spy(key, fn.forward))
    return counts


@pytest.mark.parametrize("name,kw", [
    ("zamba2-1.2b", CONFIGS["zamba2-1.2b"]),
    ("whisper-small", dict(n_layers=2, d_model=64, d_ff=128, vocab=128)),
])
def test_recompute_runs_the_decoder_blocks_again(name, kw, monkeypatch):
    """A training step runs each decoder block's kernels twice (forward,
    then the recompute in the backward) and whisper's encoder and the final
    norm once; a forward without a gradient once."""
    cfg = get_config(name).reduced(**kw)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    batch = (tokens, tokens)
    if cfg.frontend:
        batch += (torch.randn(2, cfg.frontend_seq, cfg.frontend_dim, generator=gen),)
    counts = _count_calls(monkeypatch)
    with torch.no_grad():
        transformer.loss_fn(params, cfg, batch)
    once = dict(counts)
    kinds = list(cfg.block_pattern) * cfg.pattern_repeats()
    e = cfg.encoder_layers
    decoder = {"rmsnorm": once["rmsnorm"] - 1 - (2 * e + 1 if e else 0),
               "flash_attention": once["flash_attention"] - e,
               "ssd_scan": once["ssd_scan"]}
    assert decoder["ssd_scan"] == kinds.count("mamba2")
    assert decoder["flash_attention"] == sum(
        k in ("attn", "shared_attn", "dec") for k in kinds) + kinds.count("dec")
    for k in counts:
        counts[k] = 0
    torch.func.grad(transformer.loss_fn)(params, cfg, batch)
    assert counts == {k: once[k] + decoder[k] for k in once}
    for k in counts:
        counts[k] = 0
    torch.func.grad(transformer.loss_fn)(params, dataclasses.replace(cfg, remat="none"), batch)
    assert counts == once


def test_recompute_costs_nothing_without_a_gradient(monkeypatch):
    """No grad, serving, the gate's scoring: the group runs as a plain call."""
    cfg, params, tokens, _ = _setup("smollm-360m")
    monkeypatch.setattr(remat._Recompute, "apply", lambda *a: pytest.fail("Function applied"))
    with torch.no_grad():
        transformer.loss_fn(params, cfg, (tokens[0], tokens[0]))
    transformer.forward(params, cfg, tokens[0])  # no input requires grad
    transformer.prefill(params, cfg, tokens[0], max_seq=24)


def test_remat_refuses_an_unknown_mode():
    cfg, params, tokens, _ = _setup("smollm-360m")
    with pytest.raises(ValueError, match="remat must be one of"):
        transformer.loss_fn(params, dataclasses.replace(cfg, remat="selective"),
                            (tokens[0], tokens[0]))


def test_slstm_segment_in_a_zoo_round_equals_the_plain_loop():
    """``build_round_step`` (client_parallel: ``vmap`` over the slots of R
    local ``grad`` steps) on reduced xlstm-125m with ``slstm_segment=4``
    against 0, with ``remat`` full (nested recomputes) and none.  The sLSTM
    gradient sums its steps a segment at a time, so f32 rounding apart."""
    cfg, params, tokens, targets = _setup("xlstm-125m", c=3, s=8)
    spec = RoundSpec(cohort=3, local_steps=2, local_lr=0.05)
    toks = torch.stack([tokens, tokens.roll(1, -1)], 1)  # (C, R, B, S)
    tgts = torch.stack([targets, targets.roll(1, -1)], 1)
    weights = torch.tensor([0.5, 0.0, 0.25])
    outs = {}
    for mode, segment in (("none", 0), ("none", 4), ("full", 4)):
        c = dataclasses.replace(cfg, remat=mode, slstm_segment=segment)
        outs[mode, segment] = build_round_step(c, spec)(params, toks, tgts, weights)
    want = outs["none", 0]
    for key, got in outs.items():
        exact = key[1] == 0
        torch.testing.assert_close(got[2], want[2], rtol=0 if exact else 1e-6,
                                   atol=0 if exact else 1e-7)
        torch.testing.assert_close(got[1], want[1], rtol=0 if exact else 1e-6,
                                   atol=0 if exact else 1e-7)
        for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0, atol=0 if exact else 1e-6 * scale)


def test_second_order_through_a_recompute():
    """``grad`` of ``grad`` takes the generic path: the outer level records
    the recomputed body's vjp, and the Hessian-vector product is the plain
    one's."""
    w = torch.randn(5, generator=torch.Generator().manual_seed(2))
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(3))

    def body(w, x):
        return (torch.tanh(x * w).sum(-1) ** 2).sum()

    def plain(w):
        return body(w, x)

    def recomputed(w):
        return remat.recompute(body, w, x)

    v = torch.ones(5)
    for f in (plain, recomputed):
        f.hvp = torch.func.grad(lambda w, f=f: (torch.func.grad(f)(w) * v).sum())(w)
    torch.testing.assert_close(recomputed.hvp, plain.hvp, rtol=1e-6, atol=1e-6)
