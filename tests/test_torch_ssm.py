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


def _tf32(v):
    """The kernel's TF32 on the CPU: f32 kept to 10 mantissa bits by
    truncation (the 13 low bits of the pattern masked off)."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _mma(acc, a, b, exact_a, exact_b, split=True):
    """(main, corr) + a @ b as the CUDA kernel's m16n8k8 TF32 tiles give it:
    k in steps of 8, each step adding lo*hi and hi*lo of the split operands
    to the f32 sum ``corr`` and hi*hi to the f32 sum ``main`` (the terms of
    an operand exact in TF32, bf16 values, are left out); ``split=False`` is
    plain TF32, hi*hi alone."""
    main, corr = acc
    a_hi, a_lo = (a, None) if exact_a or not split else _split(a)
    b_hi, b_lo = (b, None) if exact_b or not split else _split(b)
    if not split:
        a_hi, b_hi = _tf32(a), _tf32(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if a_lo is not None:
            corr = corr + a_lo[..., ks] @ b_hi[..., ks, :]
        if b_lo is not None:
            corr = corr + a_hi[..., ks] @ b_lo[..., ks, :]
        main = main + a_hi[..., ks] @ b_hi[..., ks, :]
    return main, corr


def _kernel_rehearsal(x, da, b, c, chunk, split=True):
    """Kernel 8's arithmetic (``csrc/ssd_scan.cu``) in plain torch: x (BH, S,
    hd) f32, da (BH, S), b and c (R, S, N) shared by BH / R heads, bf16 (exact
    in TF32) or f32.  Per chunk: the cumsum and its exps; C B^T once for the
    heads that share it; G = C B^T * exp2((cum_t - cum_s) log2 e) [s <= t],
    results under 2^-126 flushed to 0;
    y = exp(cum_t) (C S^T), then + G X on the same two sums, added at the
    end; S^T <- exp(cum_last) S^T + B^T (X * exp(cum_last - cum_s)).
    Returns y and the final state (BH, hd, N)."""
    exact = b.dtype == torch.bfloat16
    bh, s, hd = x.shape
    r, n = b.shape[0], b.shape[2]
    g = bh // r
    q = min(chunk, s)
    xf, daf = x.float().reshape(r, g, s, hd), da.float().reshape(r, g, s)
    bf, cf = b.float(), c.float()
    state = torch.zeros(r, g, n, hd)  # S^T
    above = ~torch.ones(q, q, dtype=torch.bool).tril()
    ys = []
    for s0 in range(0, s, q):
        qn, pad = min(q, s - s0), q - min(q, s - s0)
        xq = torch.nn.functional.pad(xf[:, :, s0 : s0 + qn], (0, 0, 0, pad))
        dq = torch.nn.functional.pad(daf[:, :, s0 : s0 + qn], (0, pad))
        bq, cq = (torch.nn.functional.pad(t[:, s0 : s0 + qn], (0, 0, 0, pad)) for t in (bf, cf))
        cum = torch.cumsum(dq, -1)
        last = cum[..., -1:]
        zero = torch.zeros(r, q, q)
        cbt = sum(_mma((zero, zero), cq, bq.transpose(-1, -2), exact, exact, split))
        arg = ((cum[..., :, None] - cum[..., None, :]) * 1.4426950408889634).masked_fill(above, -np.inf)
        decay = torch.exp2(arg)
        gm = cbt[:, None] * torch.where(decay < 2.0**-126, 0.0, decay)  # ex2.approx.ftz
        zero = torch.zeros(r, g, q, hd)
        acc = _mma((zero, zero), cq[:, None], state, exact, False, split)
        acc = tuple(t * torch.exp(cum)[..., None] for t in acc)
        ys.append(sum(_mma(acc, gm, xq, False, False, split))[:, :, :qn])
        zero = torch.zeros(r, g, n, hd)
        upd = _mma((zero, zero), bq.transpose(-1, -2)[:, None],
                   xq * torch.exp(last - cum)[..., None], exact, False, split)
        state = torch.exp(last)[..., None] * state + sum(upd)
    return torch.cat(ys, 2).reshape(bh, s, hd), state.transpose(-1, -2).reshape(bh, hd, n)


@pytest.mark.parametrize("bc", ["bf16", "f32"])
@pytest.mark.parametrize("da_value", [None, -0.75])
def test_kernel_arithmetic_rehearsal_matches_pallas(bc, da_value):
    """The CUDA kernel's precision choice, rehearsed on the CPU before it runs
    on a card: its arithmetic (``_kernel_rehearsal``: TF32 tiles, the
    hi/lo split of every f32 operand, bf16 b/c exact in TF32) gives y within
    1e-4 of the Pallas kernel's (interpret mode) and the final state within
    1e-4 of the sequential oracle's, each relative to the largest value, at
    the realistic decays and at -0.75 a step, with b and c shared by two
    heads and a ragged last chunk.  Plain TF32 (no split) lands at least ten
    times further off, so the split is what holds the bound."""
    bsz, h, s, hd, n, chunk = 2, 2, 256, 32, 16, 128
    x, da, b, c = _inputs(bsz * h, s, hd, n, seed=21, da_value=da_value)
    b, c = b[::h], c[::h]  # one b/c row per batch row, shared by its h heads
    if bc == "bf16":  # the values bf16 holds, so both packages see the same
        b, c = (np.asarray(torch.from_numpy(t).bfloat16().float()) for t in (b, c))
    xt, dat = torch.from_numpy(x), torch.from_numpy(da)
    bt, ct = (torch.from_numpy(np.ascontiguousarray(t)) for t in (b, c))
    if bc == "bf16":
        bt, ct = bt.bfloat16(), ct.bfloat16()
        assert torch.equal(_tf32(bt.float()), bt.float())  # exact in TF32
    b_rows, c_rows = (np.repeat(t, h, axis=0) for t in (b, c))
    y_want = _f32(jax_ssd(*(jnp.asarray(t) for t in (x, da, b_rows, c_rows)), chunk=chunk,
                          interpret=True))
    _, st_want = jref.ssd_reference(*(jnp.asarray(t) for t in (x, da, b_rows, c_rows)))
    st_want = _f32(st_want)
    errs = {}
    for split in (True, False):
        y, st = _kernel_rehearsal(xt, dat, bt, ct, chunk, split=split)
        errs[split] = (np.abs(_f32(y) - y_want).max() / np.abs(y_want).max(),
                       np.abs(_f32(st) - st_want).max() / np.abs(st_want).max())
    assert max(errs[True]) <= 1e-4, errs
    assert max(errs[True]) * 10 <= max(errs[False]), errs
    # A ragged last chunk (S = 200): against the port's plain version.
    y, st = _kernel_rehearsal(xt[:, :200], dat[:, :200], bt[:, :200], ct[:, :200], chunk)
    y_p, st_p = ref.ssd_scan_reference(xt[:, :200], dat[:, :200], bt[:, :200], ct[:, :200],
                                       chunk=chunk, return_state=True)
    assert float((y - y_p).abs().max() / y_p.abs().max()) <= 1e-4
    assert float((st - st_p).abs().max() / st_p.abs().max()) <= 1e-4


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
    "bsz,h,s,hd,n,chunk,variant",
    [(8, 64, 512, 64, 64, 128, "shared"), (2, 3, 200, 64, 64, 128, "shared"),
     (4, 1, 128, 128, 16, 128, "shared"), (1, 2, 200, 16, 8, 8, "shared"),
     (1, 1, 13, 7, 5, 13, "shared"),
     # b/c in f32 whatever x's dtype (the split products of C B^T), b/c a
     # row each (G = 1), a decay of -0.75 a step, and head counts that leave
     # the last head group of a block short or hold one head.  The kernel
     # picks 4, 2 or 1 heads a block by how well the grid fills the SMs, so
     # the batches are wide enough that an H100 (132 SMs) takes groups of 2
     # for H = 3 (2 + 1) and H = 5 (2 + 2 + 1), and of 4 for H = 6 (4 + 2).
     (8, 64, 256, 64, 64, 128, "f32 b/c"), (66, 3, 64, 64, 64, 64, "f32 b/c"),
     (2, 8, 256, 64, 64, 128, "per-row b/c"), (2, 64, 512, 64, 64, 128, "strong decay"),
     (33, 5, 96, 64, 64, 64, "strong decay"), (66, 6, 64, 96, 32, 64, "shared"),
     (4, 1, 256, 64, 64, 128, "f32 b/c")],
)
def test_cuda_ssd_scan_matches_plain(cuda, dtype, bsz, h, s, hd, n, chunk, variant):
    """zamba2's prefill shape with x as the model's (B, H, S, hd) view and b,
    c shared by the heads, a ragged S, hd split across blocks, the model's
    small chunk, and odd widths; b/c in f32, b/c per row, strong decays and
    head counts the kernel's head groups do not divide; y and the final
    state."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    dt = DTYPES[dtype][0]
    bc_dt = torch.float32 if variant == "f32 b/c" else dt
    x = torch.randn(bsz, s, h, hd, generator=gen, device=cuda).to(dt).transpose(1, 2)
    if variant == "strong decay":
        da = torch.full((bsz, s, h), -0.75, device=cuda).transpose(1, 2)
    else:
        da = -0.1 * torch.rand(bsz, s, h, generator=gen, device=cuda).transpose(1, 2)
    b, c = (0.5 * torch.randn(bsz, s, n, generator=gen, device=cuda).to(bc_dt) for _ in range(2))
    if variant == "per-row b/c":
        b, c = (t.repeat_interleave(h, dim=0) for t in (b, c))
    before = ssd_mod.ssd_scan.launches
    y, st = ssd_mod.ssd_scan(x, da, b, c, chunk=chunk, return_state=True)
    assert ssd_mod.ssd_scan.launches == before + 1
    y_want, st_want = ref.ssd_scan_reference(x, da, b, c, chunk=chunk, return_state=True)
    tol = BF16_TOL if dtype == "bf16" else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, y_want, **tol)
    torch.testing.assert_close(st, st_want, **tol)
