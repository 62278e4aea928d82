"""Gradients through kernels 6-8 of the port (``rmsnorm``,
``flash_attention``, ``ssd_scan``) against ``jax.grad`` of the reference, on
the CPU.

Each wrapper is a ``torch.autograd.Function`` on every device: on the CPU
its forward is the plain version and its backward the same PyTorch code the
card runs after the kernel, so these tests check the backward formulas and
the vmap rules:

* ``torch.func.vmap(torch.func.grad(...))`` over each wrapper equals a loop
  of ``grad`` (kernel 6 with a batched scale, as a vmap over clients'
  parameters gives it);
* ``loss_fn``'s gradients for reduced smollm-360m and a reduced zamba2-1.2b
  equal ``jax.grad`` of ``repro.models.transformer.loss_fn`` on the same
  weights (carried across by ``transformer.params_from_reference``);
* ``kernels.ops.flash_attention_trainable``'s gradients equal those of
  ``repro.kernels.ops.flash_attention_trainable`` on tests/test_flash_vjp.py's
  inputs (its Pallas forward in interpret mode, its jnp backward).

The card's gradients are held against these CPU ones by the ``cuda`` tests
of tests/test_torch_models_serve_kernels.py and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fed.tasks import tree_leaves  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

# The reference's f32 kernel tolerance (tests/test_kernels.py): the vmapped
# and looped calls, and the two attention backwards, sum in other orders.
F32_TOL = dict(rtol=1e-5, atol=1e-4)
# Whole-model gradients against jax.grad: the model files' forward tolerance
# (tests/test_torch_models.py, tests/test_torch_hybrid.py), since the two
# frameworks differ by a few ulps an op, two to nineteen blocks deep.
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)

# One warm-up call: the first multithreaded torch.exp of a process is
# sometimes off by ~1.5e-4 relative in torch's CPU build
# (tests/test_torch_cold_exp.py shows it with torch and numpy alone).
torch.exp(torch.zeros(1 << 16))

V = 3  # the vmapped axis: clients


def _inputs(name):
    """Inputs of each wrapper with a leading client axis V, from a seed:
    rmsnorm x (V, 8, 64) and a batched scale (V, 64); flash_attention q
    (V, 1, 4, 40, 32) over k, v (V, 1, 2, 40, 32); ssd_scan x (V, 1, 2, 40,
    16), da, and b, c (V, 1, 40, 8) shared by the 2 heads."""
    rng = np.random.default_rng(7)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if name == "rmsnorm":
        return f(V, 8, 64), 0.1 * f(V, 64)
    if name == "flash_attention":
        return f(V, 1, 4, 40, 32), f(V, 1, 2, 40, 32), f(V, 1, 2, 40, 32)
    da = -torch.from_numpy(rng.random((V, 1, 2, 40)).astype(np.float32))
    return f(V, 1, 2, 40, 16), da, f(V, 1, 40, 8), f(V, 1, 40, 8)


def _loss(name):
    """A scalar of each wrapper's outputs (kernel 8: y and the final
    state, so both cotangents reach the backward)."""
    if name == "rmsnorm":
        return lambda x, s: rms.rmsnorm(x, s).square().sum()
    if name == "flash_attention":
        return lambda q, k, v: fa.flash_attention(
            q, k, v, q_groups=2, causal=True, window=16, softcap=5.0).square().sum()

    def scan(*a):
        y, state = ssd.ssd_scan(*a, chunk=16, return_state=True)
        return y.square().sum() + state.square().sum()
    return scan


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "ssd_scan"])
def test_vmap_grad_equals_loop(name):
    """vmap over clients of ``grad`` with respect to every input equals a
    Python loop of ``grad``: kernel 6 takes its looping rule (batched
    scale), kernels 7 and 8 fold the client axis into B."""
    args = _inputs(name)
    grad = torch.func.grad(_loss(name), argnums=tuple(range(len(args))))
    got = torch.func.vmap(grad)(*args)
    for i in range(V):
        want = grad(*(a[i] for a in args))
        for g_got, g_want in zip(got, want, strict=True):
            torch.testing.assert_close(g_got[i], g_want, **F32_TOL)


# (reference config name, reduced overrides): a 2-layer smollm, and a
# 4-slot hybrid (three mamba2 blocks and the shared attention block).
MODELS = {
    "smollm-360m": dict(n_layers=2, d_model=64, d_ff=128, vocab=64),
    "zamba2-1.2b": dict(n_layers=4, block_pattern=("mamba2", "mamba2", "mamba2", "shared_attn"),
                        vocab=64),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_fn_grads_match_jax(name):
    """The port's ``loss_fn`` gradients (through the three Functions'
    backwards) equal ``jax.grad`` of the reference's ``loss_fn`` on the
    reference's own weights, leaf for leaf in the reference's tree order."""
    ref_cfg = ref_get_config(name).reduced(**MODELS[name])
    cfg = get_config(name).reduced(**MODELS[name])
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    params = transformer.params_from_reference(np_params, cfg, "cpu")
    rng = np.random.default_rng(3)
    tokens, targets = (rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32) for _ in range(2))

    got = torch.func.grad(transformer.loss_fn)(
        params, cfg, (torch.from_numpy(tokens), torch.from_numpy(targets)))
    want = jax.grad(ref_tf.loss_fn)(ref_params, ref_cfg, (jnp.asarray(tokens), jnp.asarray(targets)))
    got_leaves, want_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g_got, g_want in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), **MODEL_TOL)


@pytest.mark.parametrize(
    "kw,s_k",
    [(dict(causal=True), 256), (dict(causal=True, window=64), 256),
     (dict(causal=True, softcap=30.0), 256), (dict(causal=False), 256),
     (dict(causal=True, window=8, softcap=30.0), 64)],
    ids=["causal", "window", "softcap", "full", "masked-rows"],
)
def test_flash_attention_trainable_matches_reference(kw, s_k):
    """tests/test_flash_vjp.py's inputs and cotangent through both packages'
    ``flash_attention_trainable``: outputs and the gradients of
    sum(out * do) with respect to q, k and v.  In the last case 64 keys and
    a window of 8 leave query rows 71-255 with no valid key: their output
    is the mean of v, and their gradient reaches v alone."""
    h, s, hd = 2, 256, 64
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    q, do = (jax.random.normal(ks[i], (h, s, hd)) for i in (0, 3))
    k, v = (jax.random.normal(ks[i], (h, s_k, hd)) for i in (1, 2))
    flags = (kw.get("causal", True), kw.get("window"), kw.get("softcap"))

    def f_ref(q, k, v):
        return jnp.sum(jops.flash_attention_trainable(q, k, v, *flags) * do)

    want = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
    args = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention_trainable(*args, *flags)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jops.flash_attention_trainable(q, k, v, *flags)), **F32_TOL)
    got = torch.autograd.grad((out * torch.from_numpy(np.array(do))).sum(), args)
    for g_got, g_want in zip(got, want, strict=True):
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), **F32_TOL)


def test_calls_without_gradients_skip_the_function():
    """A call that needs no gradient runs the Function's forward directly
    (``_common.needs_autograd``); one with an input that requires grad, or
    under ``torch.func.grad`` or ``vmap``, goes through the Function, whose
    backward and vmap rule it then needs."""
    from repro_torch.kernels._common import needs_autograd

    x, s = _inputs("rmsnorm")
    seen = []

    def probe(x, s):
        seen.append(needs_autograd(x, s))
        return rms.rmsnorm(x, s).sum()

    probe(x[0], s[0])
    with torch.no_grad():
        probe(x[0].requires_grad_(False), s[0])
    probe(x[0].clone().requires_grad_(True), s[0])
    torch.func.grad(probe)(x[0], s[0])
    torch.func.vmap(probe)(x, s)
    assert seen == [False, False, True, True, True]
