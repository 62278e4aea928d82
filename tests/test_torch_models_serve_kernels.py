"""Kernels 6 and 7 of the port (``rmsnorm``, ``flash_attention``): their plain
versions against the JAX Pallas kernels (``interpret=True``, as
tests/test_kernels.py runs them) and the reference's ``ref`` oracles, the
port's extensions (ragged rows and sequences, grouped-query heads, strided
views), and the wrappers' input checks.

The CUDA kernels run only on a GPU: the tests marked ``cuda`` hold them
against the plain versions there and skip elsewhere.  Run them on a CUDA
machine with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_models_serve_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

# tests/test_kernels.py's tolerances: f32 sums in another order than XLA's,
# bf16 outputs one rounding apart.
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
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
@pytest.mark.parametrize("r,d", [(4096, 960), (8, 960), (37, 64), (5, 7)])
def test_cuda_rmsnorm_matches_plain(cuda, dtype, r, d):
    gen = torch.Generator(device=cuda).manual_seed(r)
    x = torch.randn(r, d, generator=gen, device=cuda).to(DTYPES[dtype][0])
    s = 0.1 * torch.randn(d, generator=gen, device=cuda)
    before = rms.rmsnorm.launches
    got = rms.rmsnorm(x, s)
    assert rms.rmsnorm.launches == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_reference(x, s), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,g,s,hd,mode",
    [(8, 15, 3, 512, 64, "causal"), (2, 6, 3, 200, 64, "causal"), (1, 4, 2, 512, 128, "window"),
     (1, 2, 1, 256, 256, "softcap"), (1, 3, 1, 128, 32, "full")],
)
def test_cuda_flash_attention_matches_plain(cuda, dtype, b, h, g, s, hd, mode):
    gen = torch.Generator(device=cuda).manual_seed(s)
    dt = DTYPES[dtype][0]
    q = torch.randn(b, h, s, hd, generator=gen, device=cuda).to(dt)
    k, v = (torch.randn(b, h // g, s, hd, generator=gen, device=cuda).to(dt) for _ in range(2))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, q_groups=g, **MODES[mode])
    assert fa.flash_attention.launches == before + 1
    want = ref.mha_reference(q, k, v, q_groups=g, **MODES[mode])
    torch.testing.assert_close(got, want, **_tol(dtype))
