"""Kernel 8 of the port (``ssd_scan``) and the Mamba2 block
(``repro_torch.models.ssm``) against the JAX reference on the CPU.

The kernel's plain version (``kernels.ref.ssd_scan_reference``, what the
wrapper runs for CPU tensors) is held against the Pallas kernel in
interpret mode (as tests/test_kernels.py runs it) at the same chunk, and
against the sequential oracle ``repro.kernels.ref.ssd_reference``; then the
port's extensions (a ragged last chunk, the final state, b and c shared
across heads, strided x) and strong decays.  ``ssd_chunked``,
``mamba2_block`` and ``mamba2_decode_step`` are held against
``repro.models.ssm`` on the reference's own weights.

Tolerances: f32 against the Pallas kernel and the JAX model path rtol 1e-4,
atol 1e-5 (the same math summed in other orders); against the sequential
oracle the reference's own 1e-3 (tests/test_kernels.py: a chunked sum
against a step-by-step one); bf16 3e-2 (one bf16 rounding of y).

The CUDA kernel runs only on a GPU: the tests marked ``cuda`` hold it
against the plain version there and skip elsewhere (``PYTHONPATH=src python
-m pytest -q -m cuda tests/test_torch_ssm.py`` on a CUDA machine with jax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-5)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
SWEEP = [(2, 256, 64, 32, 128), (1, 512, 32, 64, 64), (4, 128, 128, 16, 128)]  # test_kernels.py:56

# The first multithreaded torch.exp of a process on torch's CPU build is
# sometimes off by up to 1.5e-4 relative on one thread's share of the
# elements, and right from the second call on: tests/test_torch_cold_exp.py
# shows it with torch and numpy alone.  One call here keeps the f32
# comparisons about the port.
torch.exp(torch.zeros(1 << 16))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype="f32"):
    """The same (bf16-rounded when asked) values in both frameworks."""
    t_dt, j_dt = DTYPES[dtype]
    return torch.from_numpy(np.ascontiguousarray(a)).to(t_dt), jnp.asarray(a, j_dt)


def _inputs(bh, s, hd, n, seed, da_value=None):
    """x ~ N(0, 1); da = -softplus(N(0, 1)) * 0.1 (tests/test_kernels.py's
    'realistic' decays) or a constant; b, c ~ N(0, 0.25)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, hd)).astype(np.float32)
    if da_value is None:
        da = (-np.log1p(np.exp(rng.standard_normal((bh, s)))) * 0.1).astype(np.float32)
    else:
        da = np.full((bh, s), da_value, np.float32)
    b = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    c = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    return x, da, b, c


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bh,s,hd,n,chunk", SWEEP)
def test_ssd_plain_matches_pallas(dtype, bh, s, hd, n, chunk):
    """The reference's sweep: the plain version against the Pallas kernel
    (interpret mode) at the same chunk, and against the sequential oracle."""
    arrs = _inputs(bh, s, hd, n, seed=bh * s + hd)
    (x, xj), (da, daj), (b, bj), (c, cj) = (_pair(a, dtype) for a in arrs)
    got = ops.ssd_scan(x, da, b, c, chunk=chunk)
    assert got.dtype == x.dtype and got.shape == (bh, s, hd)
    want = jax_ssd(xj, daj, bj, cj, chunk=chunk, interpret=True)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    oracle, _ = jref.ssd_reference(xj, daj.astype(jnp.float32), bj, cj)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **(BF16_TOL if dtype == "bf16" else ORACLE_TOL))


@pytest.mark.parametrize("s,chunk", [(256, 64), (200, 64), (13, 128), (7, 3)])
def test_ssd_final_state_and_ragged_s_match_oracle(s, chunk):
    """y and the final state against the sequential oracle, including a
    ragged last chunk (S=200 at 64, S=7 at 3: the Pallas kernel asserts
    S % Q == 0, so only the oracle compares there).  The port's own
    ``ssd_reference`` is the JAX one's twin."""
    arrs = _inputs(3, s, 16, 8, seed=s)
    (x, xj), (da, daj), (b, bj), (c, cj) = (_pair(a) for a in arrs)
    y, state = ops.ssd_scan(x, da, b, c, chunk=chunk, return_state=True)
    assert state.shape == (3, 16, 8) and state.dtype == torch.float32
    y_want, state_want = jref.ssd_reference(xj, daj, bj, cj)
    np.testing.assert_allclose(_f32(y), _f32(y_want), **ORACLE_TOL)
    np.testing.assert_allclose(_f32(state), _f32(state_want), **ORACLE_TOL)
    y_seq, state_seq = ref.ssd_reference(x, da, b, c)
    np.testing.assert_allclose(_f32(y_seq), _f32(y_want), **F32_TOL)
    np.testing.assert_allclose(_f32(state_seq), _f32(state_want), **F32_TOL)
    if s % chunk == 0:  # the Pallas kernel's y where it runs
        np.testing.assert_allclose(
            _f32(y), _f32(jax_ssd(xj, daj, bj, cj, chunk=chunk, interpret=True)), **F32_TOL
        )


def test_head_shared_bc_and_strided_x_equal_the_repeated_form():
    """b, c given once per batch row ((B, S, N), row i reading b[i // H])
    equal the repeated (BH, S, N) form, and x given as the (B, H, S, hd)
    view of a (B, S, H, hd) tensor equals the contiguous (BH, S, hd) form."""
    rng = np.random.default_rng(5)
    bsz, h, s, hd, n = 2, 3, 40, 8, 4
    x_bshd = torch.from_numpy(rng.standard_normal((bsz, s, h, hd)).astype(np.float32))
    da_bsh = torch.from_numpy(-0.2 * rng.random((bsz, s, h)).astype(np.float32))
    b = torch.from_numpy(0.5 * rng.standard_normal((bsz, s, n)).astype(np.float32))
    c = torch.from_numpy(0.5 * rng.standard_normal((bsz, s, n)).astype(np.float32))
    x_view, da_view = x_bshd.transpose(1, 2), da_bsh.transpose(1, 2)
    y4, st4 = ops.ssd_scan(x_view, da_view, b, c, chunk=16, return_state=True)
    assert y4.shape == (bsz, h, s, hd) and st4.shape == (bsz * h, hd, n)
    x3 = x_view.reshape(bsz * h, s, hd)
    da3 = da_view.reshape(bsz * h, s)
    b3, c3 = (t.repeat_interleave(h, dim=0) for t in (b, c))
    y3, st3 = ops.ssd_scan(x3, da3, b3, c3, chunk=16, return_state=True)
    torch.testing.assert_close(y4.reshape(bsz * h, s, hd), y3, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(st4, st3, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _f32(y3), _f32(jax_ssd(*(jnp.asarray(t.numpy()) for t in (x3, da3, b3, c3)), chunk=8,
                               interpret=True)), **F32_TOL,
    )


@pytest.mark.parametrize("da_value", [-float(np.log(2.0)), -0.75])
def test_strong_decays_give_no_nan(da_value):
    """The reference's init (a_log = 0, dt_bias = 0: da = -softplus(0) =
    -0.693 a step) and a stronger decay: within a 128-step chunk cum reaches
    -89 and -96, so exp(cum_t - cum_s) above the diagonal reaches e^89 and
    overflows f32 at e^96; masking by multiplication would give inf * 0 =
    NaN.  y and the state are finite and match the oracle."""
    x, da, b, c = _inputs(2, 256, 16, 8, seed=11, da_value=da_value)
    (x, xj), (da, daj), (b, bj), (c, cj) = (_pair(a) for a in (x, da, b, c))
    y, state = ops.ssd_scan(x, da, b, c, chunk=128, return_state=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    y_want, state_want = jref.ssd_reference(xj, daj, bj, cj)
    np.testing.assert_allclose(_f32(y), _f32(y_want), **ORACLE_TOL)
    np.testing.assert_allclose(_f32(state), _f32(state_want), **ORACLE_TOL)
    np.testing.assert_allclose(
        _f32(y), _f32(jax_ssd(xj, daj, bj, cj, chunk=128, interpret=True)), **F32_TOL
    )


def test_ssd_kernel_matches_model_chunked_path():
    """tests/test_kernels.py:75's counterpart: kernel 8 on per-head
    flattened inputs with explicit decays (b, c repeated, as the reference
    test feeds the Pallas kernel) equals the model's chunked path, the
    port's and the reference's."""
    rng = np.random.default_rng(0)
    bsz, s, h, hd, n = 2, 256, 3, 32, 16
    x = rng.standard_normal((bsz, s, h, hd)).astype(np.float32)
    dt = (0.1 * rng.standard_normal((bsz, s, h))).astype(np.float32)
    a_log = (0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.5 * rng.standard_normal((bsz, s, n))).astype(np.float32)
    c = (0.5 * rng.standard_normal((bsz, s, n))).astype(np.float32)
    d_skip = np.zeros(h, np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, a_log, b, c, d_skip)]
    y_model = ssm.ssd_chunked(*t, chunk=128)
    y_ref = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, b, c, d_skip)), chunk=128)
    np.testing.assert_allclose(_f32(y_model), _f32(y_ref), **F32_TOL)

    dtf = torch.nn.functional.softplus(t[1])
    da = dtf * (-torch.exp(t[2]))[None, None, :]
    xa = t[0] * dtf[..., None]
    xa_f = xa.movedim(2, 1).reshape(bsz * h, s, hd)
    da_f = da.movedim(2, 1).reshape(bsz * h, s)
    b_f, c_f = (u.repeat_interleave(h, dim=0) for u in (t[3], t[4]))
    y_k = ops.ssd_scan(xa_f, da_f, b_f, c_f, chunk=128)
    y_k = y_k.reshape(bsz, h, s, hd).movedim(1, 2)
    np.testing.assert_allclose(_f32(y_k), _f32(y_model), **F32_TOL)


def _ref_cfg():
    return ref_get_config("zamba2-1.2b").reduced()


def _cfg():
    return get_config("zamba2-1.2b").reduced()


def _mamba_weights(seed=0):
    """The reference's Mamba2 weights (reduced zamba2: d_model 128, d_in 256,
    16 heads of 16, N 16), as numpy, JAX and torch trees."""
    params = ref_ssm.init_mamba2(_ref_cfg(), jax.random.PRNGKey(seed))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return params, {k: torch.from_numpy(v.copy()) for k, v in np_params.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("s", [13, 128, 200])
def test_ssd_chunked_matches_reference(s):
    """At the model's chunk rule (min(128, S), halved until it divides S:
    13, 128 and 8), with the final state."""
    rng = np.random.default_rng(s)
    bsz, h, hd, n = 2, 4, 16, 8
    ch = min(128, s)
    while s % ch:
        ch //= 2
    arrs = (
        rng.standard_normal((bsz, s, h, hd)).astype(np.float32),
        rng.standard_normal((bsz, s, h)).astype(np.float32),
        (0.3 * rng.standard_normal(h)).astype(np.float32),
        (0.5 * rng.standard_normal((bsz, s, n))).astype(np.float32),
        (0.5 * rng.standard_normal((bsz, s, n))).astype(np.float32),
        rng.standard_normal(h).astype(np.float32),
    )
    y, state = ssm.ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk=ch, return_state=True)
    y_ref, state_ref = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk=ch, return_state=True)
    np.testing.assert_allclose(_f32(y), _f32(y_ref), **F32_TOL)
    np.testing.assert_allclose(_f32(state), _f32(state_ref), **F32_TOL)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk=s + 1)


@pytest.mark.parametrize("s", [13, 128, 200])
def test_mamba2_block_matches_reference(s):
    ref_params, params = _mamba_weights()
    x = _x((2, s, _cfg().d_model), seed=s)
    y, st = ssm.mamba2_block(params, _cfg(), torch.from_numpy(x), return_state=True)
    y_ref, st_ref = ref_ssm.mamba2_block(ref_params, _ref_cfg(), jnp.asarray(x), return_state=True)
    np.testing.assert_allclose(_f32(y), _f32(y_ref), **F32_TOL)
    np.testing.assert_allclose(_f32(st["conv"]), _f32(st_ref["conv"]), **F32_TOL)
    np.testing.assert_allclose(_f32(st["ssm"]), _f32(st_ref["ssm"]), **F32_TOL)
    y_train = ssm.mamba2_block(params, _cfg(), torch.from_numpy(x))
    torch.testing.assert_close(y_train, y, rtol=0, atol=0)


def test_mamba2_decode_step_matches_reference_and_updates_in_place():
    """Three decode steps from the prefill state; the port writes the new
    conv and SSM states into the dict it is given."""
    ref_params, params = _mamba_weights(seed=1)
    cfg, ref_cfg = _cfg(), _ref_cfg()
    x = _x((2, 16, cfg.d_model), seed=2)
    _, st = ssm.mamba2_block(params, cfg, torch.from_numpy(x[:, :13]), return_state=True)
    _, st_ref = ref_ssm.mamba2_block(ref_params, ref_cfg, jnp.asarray(x[:, :13]), return_state=True)
    ptrs = (st["conv"].data_ptr(), st["ssm"].data_ptr())
    for i in range(13, 16):
        y, out = ssm.mamba2_decode_step(params, cfg, torch.from_numpy(x[:, i : i + 1]), st)
        y_ref, st_ref = ref_ssm.mamba2_decode_step(ref_params, ref_cfg, jnp.asarray(x[:, i : i + 1]), st_ref)
        assert out is st and (st["conv"].data_ptr(), st["ssm"].data_ptr()) == ptrs
        np.testing.assert_allclose(_f32(y), _f32(y_ref), **F32_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(_f32(st["conv"]), _f32(st_ref["conv"]), **F32_TOL)
        np.testing.assert_allclose(_f32(st["ssm"]), _f32(st_ref["ssm"]), **F32_TOL)


def test_decode_from_zero_state_keeps_state_dtypes():
    """``init_mamba2_state``: an f32 conv state (the reference's default)
    stays f32 through a bf16 decode step, as the reference casts it back."""
    cfg = get_config("zamba2-1.2b").reduced(param_dtype=torch.bfloat16)
    ref_cfg = ref_get_config("zamba2-1.2b").reduced(param_dtype=jnp.bfloat16)
    st = ssm.init_mamba2_state(cfg, 2)
    ref_st = ref_ssm.init_mamba2_state(ref_cfg, 2)
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == ref_st[k].shape
        assert str(st[k].dtype).removeprefix("torch.") == ref_st[k].dtype.name
    ref_params = ref_ssm.init_mamba2(ref_cfg, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in ref_params.items()}
    params = {
        k: torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
        if v.dtype.name == "bfloat16" else torch.from_numpy(v.copy())
        for k, v in np_params.items()
    }
    assert params["a_log"].dtype == torch.float32 and params["in_proj"].dtype == torch.bfloat16
    x = torch.from_numpy(_x((2, 1, cfg.d_model), seed=3)).to(torch.bfloat16)
    y, st = ssm.mamba2_decode_step(params, cfg, x, st)
    assert y.dtype == torch.bfloat16 and st["conv"].dtype == torch.float32
    y_ref, _ = ref_ssm.mamba2_decode_step(ref_params, ref_cfg, jnp.asarray(_f32(x), jnp.bfloat16), ref_st)
    np.testing.assert_allclose(_f32(y), _f32(y_ref), **BF16_TOL)


def test_wrapper_checks_and_cpu_counts_no_launch():
    x, da, b, c = (torch.from_numpy(a) for a in _inputs(4, 16, 8, 4, seed=0))
    kernels.reset_launch_counts()
    ops.ssd_scan(x, da, b, c, chunk=8)
    assert kernels.launch_counts()["ssd_scan"] == 0  # the CPU takes the plain version
    assert ops.ssd_scan is ssd_mod.ssd_scan
    with pytest.raises(ValueError, match="x must be"):
        ops.ssd_scan(x[0, 0], da, b, c)
    with pytest.raises(ValueError, match="da must be"):
        ops.ssd_scan(x, da[:, :-1], b, c)
    with pytest.raises(ValueError, match="b and c differ"):
        ops.ssd_scan(x, da, b, c[:, :, :2])
    with pytest.raises(ValueError, match="dividing"):
        ops.ssd_scan(x, da, b[:3], c[:3])
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, da, b, c, chunk=0)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.ssd_scan(x.to(torch.float64), da, b, c)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_scan(*(t.to("meta") for t in (x, da, b, c)))


# ---------------------------------------------------------------------------
# On a GPU: the CUDA kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "bsz,h,s,hd,n,chunk",
    [(8, 64, 512, 64, 64, 128), (2, 3, 200, 64, 64, 128), (4, 1, 128, 128, 16, 128),
     (1, 2, 200, 16, 8, 8), (1, 1, 13, 7, 5, 13)],
)
def test_cuda_ssd_scan_matches_plain(cuda, dtype, bsz, h, s, hd, n, chunk):
    """zamba2's prefill shape with x as the model's (B, H, S, hd) view and b,
    c shared by the heads, a ragged S, hd split across blocks, the model's
    small chunk, and odd widths; y and the final state."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    dt = DTYPES[dtype][0]
    x = torch.randn(bsz, s, h, hd, generator=gen, device=cuda).to(dt).transpose(1, 2)
    da = -0.1 * torch.rand(bsz, s, h, generator=gen, device=cuda).transpose(1, 2)
    b, c = (0.5 * torch.randn(bsz, s, n, generator=gen, device=cuda).to(dt) for _ in range(2))
    before = ssd_mod.ssd_scan.launches
    y, st = ssd_mod.ssd_scan(x, da, b, c, chunk=chunk, return_state=True)
    assert ssd_mod.ssd_scan.launches == before + 1
    y_want, st_want = ref.ssd_scan_reference(x, da, b, c, chunk=chunk, return_state=True)
    tol = BF16_TOL if dtype == "bf16" else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, y_want, **tol)
    torch.testing.assert_close(st, st_want, **tol)
