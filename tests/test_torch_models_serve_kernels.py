"""Kernels 6 and 7 of the port (``rmsnorm``, ``flash_attention``): their plain
versions against the JAX Pallas kernels (``interpret=True``, as
tests/test_kernels.py runs them) and the reference's ``ref`` oracles, the
port's extensions (ragged rows and sequences, grouped-query heads, strided
views), and the wrappers' input checks.

The CUDA kernels run only on a GPU: the tests marked ``cuda`` hold them
against the plain versions there (kernel 7 on both its paths: the
tensor-core kernel for bf16 with hd a multiple of 16 up to 128, the
CUDA-core kernel otherwise), check that gradients through the kernels (kernel
forward, PyTorch backward) equal the CPU's, and skip elsewhere.  Run them on a CUDA
machine with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_models_serve_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

# tests/test_kernels.py's tolerances: f32 sums in another order than XLA's,
# bf16 outputs one rounding apart.
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# A chunked SSD scan against the sequential oracle: the reference's own 1e-3
# (tests/test_kernels.py; ORACLE_TOL in tests/test_torch_ssm.py).
ORACLE_TOL = dict(rtol=1e-3, atol=1e-3)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
MODES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=96),
    "full": dict(causal=False),
    "softcap": dict(causal=True, softcap=30.0),
}


def _tol(dtype):
    return BF16_TOL if dtype == "bf16" else F32_TOL


def _pair(a, dtype):
    """The same (bf16-rounded when asked) values in both frameworks."""
    t_dt, j_dt = DTYPES[dtype]
    return torch.from_numpy(a).to(t_dt), jnp.asarray(a, j_dt)


def _f32(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("r,d,br", [(256, 512, 128), (128, 960, 128), (64, 128, 64), (37, 960, 37)])
def test_rmsnorm_plain_matches_pallas(dtype, r, d, br):
    """The reference's sweep shapes, plus a ragged R (37 rows: the Pallas
    kernel takes it only as one 37-row block; the port's kernel any R)."""
    rng = np.random.default_rng(r + d)
    x_t, x_j = _pair(rng.standard_normal((r, d)).astype(np.float32), dtype)
    scale = (0.1 * rng.standard_normal(d)).astype(np.float32)
    got = ops.rmsnorm(x_t, torch.from_numpy(scale))
    assert got.dtype == x_t.dtype and got.shape == (r, d)
    want = jax_rmsnorm(x_j, jnp.asarray(scale), block_rows=br, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(jref.rmsnorm_reference(x_j, jnp.asarray(scale))), **_tol(dtype))


def test_rmsnorm_bf16_scale_and_eps():
    """A bf16 scale (the bf16 models' norm weights) and another eps."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 960)).astype(np.float32)
    s = (0.1 * rng.standard_normal(960)).astype(np.float32)
    x_t, x_j = _pair(x, "bf16")
    s_t, s_j = _pair(s, "bf16")
    got = rms.rmsnorm(x_t, s_t, eps=1e-5)
    np.testing.assert_allclose(_f32(got), _f32(jref.rmsnorm_reference(x_j, s_j, eps=1e-5)), **BF16_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "h,s,hd,bq,bk",
    [(2, 256, 64, 128, 128), (1, 512, 128, 128, 256), (3, 128, 32, 64, 64), (1, 256, 256, 128, 128)],
)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_flash_attention_plain_matches_pallas(dtype, h, s, hd, bq, bk, mode):
    """tests/test_kernels.py's sweep: every shape in all four modes."""
    rng = np.random.default_rng(h * s + hd)
    q, k, v = (rng.standard_normal((h, s, hd)).astype(np.float32) for _ in range(3))
    (q_t, q_j), (k_t, k_j), (v_t, v_j) = (_pair(a, dtype) for a in (q, k, v))
    got = ops.flash_attention(q_t, k_t, v_t, **MODES[mode])
    assert got.dtype == q_t.dtype and got.shape == (h, s, hd)
    want = jax_flash(q_j, k_j, v_j, block_q=bq, block_k=bk, interpret=True, **MODES[mode])
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,kv,g,s,hd,mode",
    [(2, 2, 3, 200, 64, "causal"), (1, 5, 3, 200, 64, "window"), (2, 2, 4, 96, 32, "softcap"),
     (1, 1, 2, 77, 16, "full")],
)
def test_flash_attention_groups_and_ragged_s(dtype, b, kv, g, s, hd, mode):
    """q_groups > 1 and ragged S (not a multiple of any block) against the
    reference's ``mha_reference`` with K/V expanded over the groups."""
    rng = np.random.default_rng(s + g)
    q = rng.standard_normal((b, kv * g, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, kv, s, hd)).astype(np.float32) for _ in range(2))
    (q_t, q_j), (k_t, k_j), (v_t, v_j) = (_pair(a, dtype) for a in (q, k, v))
    got = ops.flash_attention(q_t, k_t, v_t, q_groups=g, **MODES[mode])
    assert got.shape == q_t.shape
    k_x, v_x = (jnp.repeat(t, g, axis=1).reshape(b * kv * g, s, hd) for t in (k_j, v_j))
    want = jref.mha_reference(q_j.reshape(b * kv * g, s, hd), k_x, v_x, **MODES[mode])
    np.testing.assert_allclose(_f32(got).reshape(-1, s, hd), _f32(want), **_tol(dtype))


def test_flash_attention_fully_masked_rows_average_v():
    """With S_q > S_k + window - 1 some rows have no valid key: the
    reference's -2.38e38 surrogate makes them the mean of v (not 0)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 16)).astype(np.float32) for _ in range(2))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=8)
    want = jref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got.numpy()[:, -1], v.mean(axis=1), **F32_TOL)


def test_flash_attention_strided_views():
    """The models pass (B, S, heads, hd) projections as transposed views."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 40, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2), q_groups=3)
    want = ref.mha_reference(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(), q_groups=3,
    )
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad",
    [
        lambda x, s: rms.rmsnorm(x[0], s),
        lambda x, s: rms.rmsnorm(x, s[:-1]),
        lambda x, s: rms.rmsnorm(x.to(torch.float16), s),
        lambda x, s: rms.rmsnorm(x, s.to(torch.int32)),
    ],
    ids=["1-d", "scale-shape", "f16", "int-scale"],
)
def test_rmsnorm_rejects_bad_inputs(bad):
    with pytest.raises(ValueError):
        bad(torch.ones(4, 8), torch.ones(8))


@pytest.mark.parametrize(
    "kw,shapes",
    [
        (dict(q_groups=2), ((4, 8, 16), (4, 8, 16))),  # heads not k heads x groups
        (dict(), ((2, 8, 16), (2, 8, 8))),  # hd differs
        (dict(window=0), ((2, 8, 16), (2, 8, 16))),
        (dict(softcap=-1.0), ((2, 8, 16), (2, 8, 16))),
        (dict(), ((2, 8, 16), (2, 0, 16))),  # no keys
        (dict(), ((8, 16), (8, 16))),  # rank
    ],
    ids=["groups", "hd", "window", "softcap", "no-keys", "rank"],
)
def test_flash_attention_rejects_bad_inputs(kw, shapes):
    q, k = torch.ones(shapes[0]), torch.ones(shapes[1])
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, **kw)


def test_cpu_path_counts_no_launches():
    from repro_torch import kernels

    kernels.reset_launch_counts()
    ops.rmsnorm(torch.ones(4, 8), torch.zeros(8))
    ops.flash_attention(torch.ones(2, 8, 16), torch.ones(2, 8, 16), torch.ones(2, 8, 16))
    assert kernels.launch_counts()["rmsnorm"] == 0
    assert kernels.launch_counts()["flash_attention"] == 0


def _kernel7_rounding(q, k, v, *, causal=True, window=None, softcap=None, q_groups=1):
    """``ref.mha_reference`` with the tensor-core kernel's rounding points:
    bf16 q, k, v; f32 scores; the unnormalised probabilities exp(x - max)
    rounded to bf16 before the product with v; their f32 sum (unrounded)
    divides the f32 product; the output rounded to bf16."""
    if q_groups > 1:
        k = k.repeat_interleave(q_groups, dim=-3)
        v = v.repeat_interleave(q_groups, dim=-3)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(q.shape[-2])[:, None]
    kpos = torch.arange(k.shape[-2])[None, :]
    mask = kpos <= qpos if causal else torch.ones((q.shape[-2], k.shape[-2]), dtype=torch.bool)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask, logits, ref.NEG)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.matmul(p.to(torch.bfloat16).float(), v.float()) / p.sum(-1, keepdim=True)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,h,g,s,hd,kw",
    [(2, 6, 3, 200, 64, dict(causal=True)),
     (1, 4, 2, 256, 128, dict(causal=True, window=96, softcap=30.0))],
    ids=["causal-hd64-ragged", "window-softcap-hd128"],
)
def test_flash_attention_bf16_rounding_within_tolerance(b, h, g, s, hd, kw):
    """The tensor-core kernel rounds P to bf16 before P·V, where the plain
    version keeps it in f32: a copy of the plain version with that rounding
    stays inside the bf16 tolerance the GPU checks hold the kernel to."""
    rng = np.random.default_rng(s + hd)
    q = torch.from_numpy(rng.standard_normal((b, h, s, hd)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((b, h // g, s, hd)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    rounded = _kernel7_rounding(q, k, v, q_groups=g, **kw)
    plain = ref.mha_reference(q, k, v, q_groups=g, **kw)
    assert not torch.equal(rounded, plain)  # the rounding moves some outputs
    torch.testing.assert_close(rounded, plain, **BF16_TOL)


@pytest.mark.parametrize(
    "dtype,hd,want",
    [(torch.bfloat16, 64, True), (torch.bfloat16, 128, True), (torch.bfloat16, 16, True),
     (torch.bfloat16, 96, True), (torch.bfloat16, 40, False), (torch.bfloat16, 144, False),
     (torch.bfloat16, 256, False), (torch.float32, 64, False), (torch.float32, 128, False)],
)
def test_flash_attention_path_by_dtype_and_hd(dtype, hd, want):
    assert fa.uses_tensor_cores(dtype, hd) is want


def test_flash_attention_aligned_copies_only_misaligned_views():
    """The tensor-core kernel's 16-byte copies need 16-byte pointers and
    (batch, head, seq) strides: the models' transposed views pass as they
    are, a view at an odd element offset is copied."""
    base = torch.zeros(2, 40, 6, 64, dtype=torch.bfloat16)
    view = base.transpose(1, 2)
    assert fa._aligned(view) is view
    odd = torch.zeros(2 * 6 * 40 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 6, 40, 64)
    fixed = fa._aligned(odd)
    assert fixed is not odd and fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)


# Kernel 7's mode in the gradient calls: the window and the soft cap put
# their terms into the gradient.
GRAD_FA_KW = dict(causal=True, window=16, softcap=5.0)


def _kernel_inputs(name):
    """Small f32 inputs of kernel 6, 7 or 8's wrapper, from a seed: rmsnorm
    (x, scale); flash_attention (q, k, v) with 4 query heads over 2; ssd_scan
    (x, da, b, c) with b and c shared by 2 heads."""
    rng = np.random.default_rng(0)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if name == "rmsnorm":
        return f(8, 64), f(64)
    if name == "flash_attention":
        return f(1, 4, 40, 32), f(1, 2, 40, 32), f(1, 2, 40, 32)
    return f(1, 2, 40, 16), -rng.random((1, 2, 40)).astype(np.float32), f(1, 40, 8), f(1, 40, 8)


def _kernel_call(name, dev, requires_grad=False):
    """One call of kernel 6, 7 or 8's wrapper and of its plain version on
    ``_kernel_inputs``."""
    args = tuple(torch.from_numpy(a).to(dev).requires_grad_(requires_grad)
                 for a in _kernel_inputs(name))
    wrapper, plain, kw = {
        "rmsnorm": (rms.rmsnorm, ref.rmsnorm_reference, {}),
        "flash_attention": (fa.flash_attention, ref.mha_reference, dict(q_groups=2, **GRAD_FA_KW)),
        "ssd_scan": (ssd.ssd_scan, ref.ssd_scan_reference, dict(chunk=16)),
    }[name]
    return args, lambda: wrapper(*args, **kw), lambda: plain(*args, **kw)


def _jax_plain(name):
    """The JAX package's plain version of the same function, on the port's
    argument layout: grouped K/V and shared b/c repeated over the heads."""
    if name == "rmsnorm":
        return jref.rmsnorm_reference
    if name == "flash_attention":
        def attn(q, k, v):
            g = q.shape[1] // k.shape[1]
            k, v = (jnp.repeat(t[0], g, axis=0) for t in (k, v))
            return jref.mha_reference(q[0], k, v, **GRAD_FA_KW)[None]
        return attn

    def scan(x, da, b, c):
        h = x.shape[1]
        return jref.ssd_reference(x[0], da[0], jnp.repeat(b, h, 0), jnp.repeat(c, h, 0))[0][None]
    return scan


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "ssd_scan"])
def test_cpu_wrappers_stay_differentiable(name):
    """On the CPU the wrappers stay differentiable through their
    ``torch.autograd.Function``'s backward (the code the card runs after
    the kernel): the gradient of sum(out^2) with respect to every input
    equals ``jax.grad`` of the JAX package's plain version on the same
    inputs, within the f32 tolerance
    (kernel 8: the oracle's, since the JAX plain version is the sequential
    scan, whose exact zero gradient for the first step's decay the chunked
    scan meets up to rounding)."""
    args, call, _ = _kernel_call(name, torch.device("cpu"), requires_grad=True)
    got = torch.autograd.grad(call().square().sum(), args)
    inputs = [jnp.asarray(a) for a in _kernel_inputs(name)]
    plain = _jax_plain(name)
    want = jax.grad(lambda *a: jnp.sum(plain(*a) ** 2), argnums=tuple(range(len(inputs))))(*inputs)
    tol = ORACLE_TOL if name == "ssd_scan" else F32_TOL
    for g_got, g_want in zip(got, want, strict=True):
        np.testing.assert_allclose(_f32(g_got.detach()), np.asarray(g_want), **tol)


# ---------------------------------------------------------------------------
# On a GPU: the CUDA kernels against their plain versions.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "r,d",
    # prefill and decode rows, narrow rows (a sub-warp each: qk_norm's
    # (61440, 64)), wide rows (a block a row: (8, 2048), (8, 4608)), rows
    # past a block's registers (the looped path: (3, 20000)), rows that
    # take scalar loads
    [(4096, 960), (8, 960), (37, 64), (5, 7), (61440, 64), (8, 2048), (8, 4608),
     (3, 20000), (4097, 962)],
)
def test_cuda_rmsnorm_matches_plain(cuda, dtype, r, d):
    gen = torch.Generator(device=cuda).manual_seed(r)
    x = torch.randn(r, d, generator=gen, device=cuda).to(DTYPES[dtype][0])
    s = 0.1 * torch.randn(d, generator=gen, device=cuda)
    before = rms.rmsnorm.launches
    got = rms.rmsnorm(x, s)
    assert rms.rmsnorm.launches == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_reference(x, s), **_tol(dtype))


# Kernel 7's GPU cases: MODES plus the window with the soft cap (gemma2's
# local layers) and a window that leaves rows with no valid key.
CUDA_MODES = {
    **MODES,
    "window+softcap": dict(causal=True, window=96, softcap=30.0),
    "masked rows": dict(causal=True, window=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,g,s,s_k,hd,mode",
    [(8, 15, 3, 512, 512, 64, "causal"), (2, 6, 3, 200, 200, 64, "causal"),
     (1, 4, 2, 512, 512, 128, "window"), (1, 2, 1, 256, 256, 256, "softcap"),
     (1, 3, 1, 128, 128, 32, "full"),
     # the tensor-core kernel's cases in bf16
     (2, 4, 1, 256, 256, 64, "causal"), (1, 4, 2, 512, 512, 128, "window+softcap"),
     (2, 6, 3, 200, 200, 128, "softcap"), (2, 6, 3, 100, 300, 64, "causal"),
     (2, 6, 3, 300, 100, 64, "full"), (2, 2, 1, 64, 16, 64, "masked rows"),
     (1, 3, 1, 77, 90, 96, "window+softcap")],
)
def test_cuda_flash_attention_matches_plain(cuda, dtype, b, h, g, s, s_k, hd, mode):
    gen = torch.Generator(device=cuda).manual_seed(s)
    dt = DTYPES[dtype][0]
    q = torch.randn(b, h, s, hd, generator=gen, device=cuda).to(dt)
    k, v = (torch.randn(b, h // g, s_k, hd, generator=gen, device=cuda).to(dt) for _ in range(2))
    before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v, q_groups=g, **CUDA_MODES[mode])
    assert fa.flash_attention.launches == before + 1
    tc = dtype == "bf16" and hd % 16 == 0 and hd <= 128
    assert fa.flash_attention.launches_tc == before_tc + int(tc)
    want = ref.mha_reference(q, k, v, q_groups=g, **CUDA_MODES[mode])
    torch.testing.assert_close(got, want, **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "ssd_scan"])
def test_cuda_wrapper_gradients_match_cpu(cuda, name):
    """On the card the kernel runs the forward (one launch) and the
    wrapper's PyTorch backward the gradient: the gradients of sum(out^2)
    equal the CPU's (plain forward, the same backward) on the same f32
    inputs, within the f32 tolerance (kernel 8: the oracle's, as in
    ``test_cpu_wrappers_stay_differentiable``: the first step's decay has
    an exact zero gradient that both devices meet only up to rounding)."""
    from repro_torch import kernels

    args, call, _ = _kernel_call(name, cuda, requires_grad=True)
    kernels.reset_launch_counts()
    got = torch.autograd.grad(call().square().sum(), args)
    assert kernels.launch_counts()[name] == 1
    cpu_args, cpu_call, _ = _kernel_call(name, torch.device("cpu"), requires_grad=True)
    want = torch.autograd.grad(cpu_call().square().sum(), cpu_args)
    tol = ORACLE_TOL if name == "ssd_scan" else F32_TOL
    for g_got, g_want in zip(got, want, strict=True):
        torch.testing.assert_close(g_got.cpu(), g_want, **tol)


@pytest.mark.cuda
def test_cuda_loss_fn_gradients_match_cpu(cuda):
    """A 2-layer reduced smollm's ``loss_fn`` on the card, kernels 6 and 7
    counted in the forward and, with the config's ``remat="full"``, again
    in the backward's recompute of each layer (the final norm once): loss
    and gradients equal the CPU's on the same f32 weights, within the f32
    tolerance."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.fed.tasks import tree_leaves, tree_map
    from repro_torch.models import transformer

    cfg = get_config("smollm-360m").reduced()
    assert cfg.n_layers == 2
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    batch = (tokens[:, :-1], tokens[:, 1:])
    grad_fn = torch.func.grad_and_value(transformer.loss_fn)
    kernels.reset_launch_counts()
    params_gpu, batch_gpu = tree_map(lambda t: t.to(cuda), (params, batch))
    g_gpu, l_gpu = grad_fn(params_gpu, cfg, batch_gpu)
    counts = kernels.launch_counts()
    assert cfg.remat == "full"
    assert counts["rmsnorm"] == 2 * (2 * cfg.n_layers) + 1
    assert counts["flash_attention"] == 2 * cfg.n_layers
    g_cpu, l_cpu = grad_fn(params, cfg, batch)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, **F32_TOL)
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu), strict=True):
        torch.testing.assert_close(a.cpu(), b, **F32_TOL)
