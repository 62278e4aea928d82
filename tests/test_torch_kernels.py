"""The port's aggregation kernels: their plain versions against the JAX
Pallas kernels (``interpret=True``, as tests/test_kernels.py runs them), the
estimator and ``kernels.ops`` that drive them, and the wrappers' input checks.

The CUDA kernels themselves run only on a GPU: the tests marked ``cuda`` hold
them against the plain versions there and skip elsewhere.  Run them on a
CUDA machine with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import estimator as ref_estimator  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.fused_weighted_agg import (  # noqa: E402
    fused_cohort_agg_and_error as ref_cohort,
    fused_multi_weighted_agg as ref_multi,
    fused_weighted_agg as ref_single,
)
from repro_torch.core import estimator  # noqa: E402
from repro_torch.kernels import fused_weighted_agg as fwa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(c, d, m, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((c, d)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (m, c)).astype(np.float32)
    return g, w


def _pair(g, dtype):
    """The same (bf16-rounded when asked) values in both frameworks."""
    t_dt, j_dt = DTYPES[dtype]
    return torch.from_numpy(g).to(t_dt), jnp.asarray(g, j_dt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,c,d,bd", [(2, 8, 4096, 1024), (3, 16, 2048, 2048), (2, 50, 1024, 256)])
def test_multi_plain_matches_pallas(dtype, m, c, d, bd):
    g, w = _inputs(c, d, m)
    g_t, g_j = _pair(g, dtype)
    want = np.asarray(ref_multi(g_j, jnp.asarray(w), block_d=bd, interpret=True))
    got = fwa.fused_multi_weighted_agg(g_t, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), want, **(BF16_TOL if dtype == "bf16" else F32_TOL))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,d,bd", [(8, 4096, 1024), (20, 2048, 2048), (3, 1024, 256)])
def test_cohort_plain_matches_pallas(dtype, c, d, bd):
    g, w2 = _inputs(c, d, 2, seed=1)
    w, lam_c = w2[0], w2[1] * 0.1
    w[-1] = lam_c[-1] = 0.0  # an inert padding slot
    g_t, g_j = _pair(g, dtype)
    d_want, sq_want = ref_cohort(g_j, jnp.asarray(w), jnp.asarray(lam_c), block_d=bd, interpret=True)
    d_got, sq_got = fwa.fused_cohort_agg_and_error(g_t, torch.from_numpy(w), torch.from_numpy(lam_c))
    assert d_got.shape == (d,) and sq_got.shape == ()
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), **tol)
    np.testing.assert_allclose(float(sq_got), float(sq_want), rtol=2e-2 if dtype == "bf16" else 1e-4)


@pytest.mark.parametrize("c,d", [(100, 610), (7, 1027), (1, 1)])
def test_ragged_d_matches_reference_contraction(c, d):
    """Any D: the reference's own off-TPU arithmetic ``w2 @ flat``."""
    g, w2 = _inputs(c, d, 2, seed=2)
    want = np.asarray(jnp.asarray(w2) @ jnp.asarray(g))
    got = fwa.fused_multi_weighted_agg(torch.from_numpy(g), torch.from_numpy(w2))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    lam_c = w2[0] - w2[1]
    d_got, sq_got = fwa.fused_cohort_agg_and_error(
        torch.from_numpy(g), torch.from_numpy(w2[0]), torch.from_numpy(lam_c)
    )
    w_rows = np.stack([w2[0], w2[0] - lam_c])
    want2 = np.asarray(jnp.asarray(w_rows) @ jnp.asarray(g))
    np.testing.assert_allclose(d_got.numpy(), want2[0], **F32_TOL)
    np.testing.assert_allclose(float(sq_got), float(np.sum(want2[1] ** 2)), rtol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,d,bd", [(8, 4096, 1024), (16, 2048, 2048), (3, 8192, 512)])
def test_weighted_agg_plain_matches_pallas(dtype, c, d, bd):
    """Kernel 3 at tests/test_kernels.py's sweep shapes and tolerances."""
    g, w = _inputs(c, d, 1, seed=5)
    g_t, g_j = _pair(g, dtype)
    d_want, sq_want = ref_single(g_j, jnp.asarray(w[0]), block_d=bd, interpret=True)
    d_got, sq_got = fwa.fused_weighted_agg(g_t, torch.from_numpy(w[0]))
    assert d_got.shape == (d,) and sq_got.shape == (c,) and sq_got.dtype == torch.float32
    tol = dict(rtol=2e-2, atol=1e-2) if dtype == "bf16" else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), **tol)
    np.testing.assert_allclose(sq_got.numpy(), np.asarray(sq_want), **tol)


@pytest.mark.parametrize("block_d", [512, 2048])
def test_aggregate_cohort_updates_matches_reference(block_d):
    """kernels.ops.aggregate_cohort_updates on tests/test_kernels.py's
    pytree: the same estimate and norms as the reference's ops, leaf dtypes
    kept, and block_d changes nothing."""
    rng = np.random.default_rng(3)
    c = 6
    deltas = {
        "w": rng.standard_normal((c, 33, 17)).astype(np.float32),
        "b": rng.standard_normal((c, 129)).astype(np.float32),
    }
    w = rng.uniform(0.0, 1.0, c).astype(np.float32)
    want, sq_want = ref_ops.aggregate_cohort_updates(
        _to(deltas, jnp.asarray), jnp.asarray(w), block_d=512
    )
    got, sq_got = ops.aggregate_cohort_updates(
        _to(deltas, torch.from_numpy), torch.from_numpy(w), block_d=block_d
    )
    assert sorted(got) == ["b", "w"] and got["w"].shape == (33, 17)
    assert got["w"].dtype == torch.float32
    _assert_tree_close(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sq_got.numpy(), np.asarray(sq_want), rtol=1e-5)
    stacked = estimator.aggregate_stacked(_to(deltas, torch.from_numpy), torch.from_numpy(w))
    _assert_tree_close(got, _to(stacked, np.asarray), rtol=1e-5, atol=1e-5)


def test_stacked_aggregates_match_reference():
    rng = np.random.default_rng(6)
    ups = _stacked(rng, 7)
    w = rng.uniform(0, 2, 7).astype(np.float32)
    for ref_fn, fn in (
        (ref_estimator.aggregate_stacked, estimator.aggregate_stacked),
        (ref_estimator.full_aggregate_stacked, estimator.full_aggregate_stacked),
    ):
        want = ref_fn(_to(ups, jnp.asarray), jnp.asarray(w))
        got = fn(_to(ups, torch.from_numpy), torch.from_numpy(w))
        _assert_tree_close(got, want, **F32_TOL)


def _stacked(rng, lead):
    return {
        "w": rng.standard_normal((lead, 30, 10)).astype(np.float32),
        "b": rng.standard_normal((lead, 10)).astype(np.float32),
        "blk0": {"up": rng.standard_normal((lead, 4, 6)).astype(np.float32)},
    }


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _assert_tree_close(got, want, **tol):
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **tol)


def test_estimator_matches_reference():
    """aggregate_and_error / aggregate_and_error_cohort over parameter dicts
    (flattened in tree order) and client_weights, against repro.core.estimator."""
    rng = np.random.default_rng(3)
    n = 12
    ups = _stacked(rng, n)
    weights = rng.uniform(0, 3, n).astype(np.float32)
    lam = rng.dirichlet(np.ones(n)).astype(np.float32)
    d_r, sq_r = ref_estimator.aggregate_and_error(_to(ups, jnp.asarray), jnp.asarray(weights), jnp.asarray(lam))
    d_p, sq_p = estimator.aggregate_and_error(_to(ups, torch.from_numpy), torch.from_numpy(weights), torch.from_numpy(lam))
    _assert_tree_close(d_p, d_r, **F32_TOL)
    np.testing.assert_allclose(float(sq_p), float(sq_r), rtol=1e-5)

    c = 5
    ups_c = _stacked(rng, c)
    w_c = np.array([1.3, 0.4, 2.0, 0.0, 0.0], np.float32)
    lam_c = np.array([0.1, 0.05, 0.2, 0.0, 0.0], np.float32)
    d_r, sq_r = ref_estimator.aggregate_and_error_cohort(_to(ups_c, jnp.asarray), jnp.asarray(w_c), jnp.asarray(lam_c))
    d_p, sq_p = estimator.aggregate_and_error_cohort(_to(ups_c, torch.from_numpy), torch.from_numpy(w_c), torch.from_numpy(lam_c))
    _assert_tree_close(d_p, d_r, **F32_TOL)
    np.testing.assert_allclose(float(sq_p), float(sq_r), rtol=1e-5)


def test_cpu_path_launches_nothing():
    fwa.reset_launch_counts()
    g, w = _inputs(4, 64, 2)
    g_t, w0, w1 = torch.from_numpy(g), torch.from_numpy(w[0]), torch.from_numpy(w[1])
    fwa.fused_multi_weighted_agg(g_t, torch.from_numpy(w))
    fwa.fused_cohort_agg_and_error(g_t, w0, w1)
    fwa.fused_weighted_agg(g_t, w0)
    q, scales = fwa.quantize_stacked(g_t, scale_block=16)
    fwa.fused_dequant_cohort_agg(q, scales, w0, w1)
    assert fwa.launch_counts() == {
        "fused_weighted_agg": 0,
        "fused_multi_weighted_agg": 0,
        "fused_cohort_agg_and_error": 0,
        "fused_dequant_cohort_agg": 0,
    }


@pytest.mark.parametrize(
    "g,w,match",
    [
        (torch.zeros(4), torch.zeros(2, 4), "2-D"),
        (torch.zeros(4, 8, dtype=torch.float64), torch.zeros(2, 4), "float32"),
        (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(2, 4), "float32"),
        (torch.zeros(4, 8), torch.zeros(2, 5), "shape"),
        (torch.zeros(4, 8), torch.zeros(2, 4, dtype=torch.bfloat16), "float32"),
        (torch.zeros(8, 4).T, torch.zeros(2, 4), "contiguous"),
        (torch.zeros(4, 8), torch.zeros(4, 2).T, "contiguous"),
        (torch.zeros(0, 8), torch.zeros(2, 0), "non-empty"),
        (torch.zeros(4, 8, device="meta"), torch.zeros(2, 4, device="meta"), "device"),
        (torch.zeros(4, 8), torch.zeros(2, 4, device="meta"), "expected"),
    ],
)
def test_multi_wrapper_rejects_bad_inputs(g, w, match):
    with pytest.raises(ValueError, match=match):
        fwa.fused_multi_weighted_agg(g, w)


@pytest.mark.parametrize(
    "g,w,lam,match",
    [
        (torch.zeros(4), torch.zeros(4), torch.zeros(4), "2-D"),
        (torch.zeros(4, 8, dtype=torch.float64), torch.zeros(4), torch.zeros(4), "float32"),
        (torch.zeros(4, 8), torch.zeros(5), torch.zeros(4), "shape"),
        (torch.zeros(4, 8), torch.zeros(4), torch.zeros(4, 1), "shape"),
        (torch.zeros(4, 8), torch.zeros(4), torch.zeros(4, dtype=torch.float64), "float32"),
        (torch.zeros(4, 8), torch.zeros(8)[::2], torch.zeros(4), "contiguous"),
        (torch.zeros(4, 8), torch.zeros(4), torch.zeros(4, device="meta"), "expected"),
    ],
)
def test_cohort_wrapper_rejects_bad_inputs(g, w, lam, match):
    with pytest.raises(ValueError, match=match):
        fwa.fused_cohort_agg_and_error(g, w, lam)


@pytest.mark.parametrize(
    "g,w,match",
    [
        (torch.zeros(4), torch.zeros(4), "2-D"),
        (torch.zeros(4, 8, dtype=torch.int8), torch.zeros(4), "float32"),
        (torch.zeros(4, 8), torch.zeros(5), "shape"),
        (torch.zeros(4, 8), torch.zeros(8)[::2], "contiguous"),
    ],
)
def test_weighted_agg_wrapper_rejects_bad_inputs(g, w, match):
    with pytest.raises(ValueError, match=match):
        fwa.fused_weighted_agg(g, w)


_Q = torch.zeros(4, 64, dtype=torch.int8)


@pytest.mark.parametrize(
    "q,scales,w,match",
    [
        (torch.zeros(4, 64), torch.ones(4, 2), torch.zeros(4), "int8"),
        (_Q, torch.ones(4), torch.zeros(4), "2-D"),
        (_Q, torch.ones(4, 3), torch.zeros(4), "multiple"),
        (_Q, torch.ones(5, 2), torch.zeros(4), "shape"),
        (_Q, torch.ones(4, 2, dtype=torch.float64), torch.zeros(4), "float32"),
        (_Q, torch.ones(4, 2), torch.zeros(3), "shape"),
        (_Q.T, torch.ones(64, 2), torch.zeros(64), "contiguous"),
    ],
)
def test_dequant_wrapper_rejects_bad_inputs(q, scales, w, match):
    with pytest.raises(ValueError, match=match):
        fwa.fused_dequant_cohort_agg(q, scales, w, torch.zeros_like(w))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,d", [(50, 114688), (10, 114688), (100, 610), (3, 1027)])
def test_cuda_kernel_matches_plain(cuda, dtype, c, d):
    g, w2 = _inputs(c, d, 2, seed=4)
    g_t = torch.from_numpy(g).to(DTYPES[dtype][0]).to(cuda)
    w_t = torch.from_numpy(w2).to(cuda)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    before = fwa.launch_counts()
    got = fwa.fused_multi_weighted_agg(g_t, w_t)
    want = ref.multi_weighted_agg_reference(g_t, w_t)
    torch.testing.assert_close(got, want, **tol)
    d_got, sq_got = fwa.fused_cohort_agg_and_error(g_t, w_t[0].contiguous(), w_t[1].contiguous())
    d_want, sq_want = ref.cohort_agg_and_error_reference(g_t, w_t[0], w_t[1])
    torch.testing.assert_close(d_got, d_want, **tol)
    torch.testing.assert_close(sq_got, sq_want, rtol=1e-4, atol=0.0)
    again = fwa.fused_cohort_agg_and_error(g_t, w_t[0].contiguous(), w_t[1].contiguous())
    assert torch.equal(again[1], sq_got)  # no float atomics: bitwise repeatable
    after = fwa.launch_counts()
    assert after["fused_multi_weighted_agg"] == before["fused_multi_weighted_agg"] + 1
    assert after["fused_cohort_agg_and_error"] == before["fused_cohort_agg_and_error"] + 2
    d3, sq3 = fwa.fused_weighted_agg(g_t, w_t[0].contiguous())
    d3_want, sq3_want = ref.weighted_agg_reference(g_t, w_t[0])
    torch.testing.assert_close(d3, d3_want, **tol)
    torch.testing.assert_close(sq3, sq3_want, rtol=1e-4, atol=0.0)
    assert torch.equal(fwa.fused_weighted_agg(g_t, w_t[0].contiguous())[1], sq3)
    assert fwa.launch_counts()["fused_weighted_agg"] == before["fused_weighted_agg"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "m,c,d", [(2, 50, 114688), (2, 100, 610), (4, 3, 1027), (1, 300, 4099), (2, 200, 8192),
              (2, 20, 1 << 21), (3, 16, 100003)],
)
def test_cuda_multi_agg_bitwise_repeatable(cuda, dtype, m, c, d):
    """Kernel 1 splits C over the warps of a block and adds their sums in a
    fixed order: two calls give the same bits, at the main path's shapes,
    at a ragged D, with more rows than 16 warps walk in one batch (loaded
    into registers, and copied in two stages), at a D with more tiles
    than the card holds blocks, and at a small C over a ragged D in f32
    (each warp walking all rows of tiles of its own).  Kernel 2 at the same shapes (its grid
    bounded by the blocks the card holds) against its plain version, its
    error scalar bitwise repeatable."""
    g, w = _inputs(c, d, m, seed=9)
    g_t = torch.from_numpy(g).to(DTYPES[dtype][0]).to(cuda)
    w_t = torch.from_numpy(w).to(cuda)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    got = fwa.fused_multi_weighted_agg(g_t, w_t)
    again = fwa.fused_multi_weighted_agg(g_t, w_t)
    torch.testing.assert_close(got, ref.multi_weighted_agg_reference(g_t, w_t), **tol)
    assert torch.equal(got, again)
    w0, lam = w_t[0].contiguous(), (0.1 * w_t[-1]).contiguous()
    d_got, e_got = fwa.fused_cohort_agg_and_error(g_t, w0, lam)
    d_want, e_want = ref.cohort_agg_and_error_reference(g_t, w0, lam)
    torch.testing.assert_close(d_got, d_want, **tol)
    torch.testing.assert_close(e_got, e_want, rtol=1e-4, atol=0.0)
    assert torch.equal(fwa.fused_cohort_agg_and_error(g_t, w0, lam)[1], e_got)


@pytest.mark.cuda
def test_cuda_cohort_agg_on_two_streams(cuda):
    """Kernel 2's last block finds itself by a ticket counter, one per
    (device, stream): launches on two streams at once give the bits of the
    same launches made in order."""
    g, w2 = _inputs(10, 114688, 2, seed=11)
    g_t = torch.from_numpy(g).to(cuda)
    ws = [torch.from_numpy(w2[i]).to(cuda) for i in range(2)]
    lam = 0.1 * ws[1]
    want = [fwa.fused_cohort_agg_and_error(g_t, w, lam) for w in ws]
    streams = [torch.cuda.Stream() for _ in ws]
    torch.cuda.synchronize()
    got = []
    for stream, w in zip(streams, ws):
        with torch.cuda.stream(stream):
            for _ in range(20):
                out = fwa.fused_cohort_agg_and_error(g_t, w, lam)
            got.append(out)
    torch.cuda.synchronize()
    for (d_got, e_got), (d_want, e_want) in zip(got, want):
        assert torch.equal(d_got, d_want) and torch.equal(e_got, e_want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize(
    "c,d,sb",
    [(50, 114688, 128), (10, 114688, 128), (100, 640, 128), (3, 1000, 40), (1, 114688, 128),
     (9, 114688, 128), (1, 1000, 40), (9, 4104, 24), (50, 8200, 8), (100, 114688, 128),
     (12, 1 << 20, 128), (4, 1 << 20, 8), (300, 4096, 64)],
)
def test_cuda_dequant_kernel_matches_plain(cuda, dtype, c, d, sb):
    """Kernel 4 against its plain version, err and the norms bitwise
    repeatable, one launch a call: the compressed path's shapes, C = 1, 9,
    50, 100 and 300 (more rows than a batch a warp), scale blocks that are
    not a multiple of 16 codes (the scalar path), and a D with tiles enough
    for each warp to own its own."""
    g, w2 = _inputs(c, d, 2, seed=7)
    q, scales = fwa.quantize_stacked(torch.from_numpy(g).to(cuda), dtype=dtype, scale_block=sb)
    w, lam = torch.from_numpy(w2[0]).to(cuda), torch.from_numpy(0.1 * w2[1]).to(cuda)
    before = fwa.launch_counts()["fused_dequant_cohort_agg"]
    got = fwa.fused_dequant_cohort_agg(q, scales, w, lam)
    want = ref.dequant_cohort_agg_reference(q, scales, w, lam)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    again = fwa.fused_dequant_cohort_agg(q, scales, w, lam)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    assert fwa.launch_counts()["fused_dequant_cohort_agg"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "c,d",
    [(1, 610), (9, 1027), (100, 610), (300, 4099), (1, 114688), (10, 114688), (50, 114688),
     (9, 1 << 20), (20, 1 << 21), (3, 1 << 21)],
)
def test_cuda_weighted_agg_matches_plain(cuda, dtype, c, d):
    """Kernel 3 against its plain version, its norms bitwise repeatable, one
    launch a call: C = 1, 9, 100 and 300 (more rows than 16 warps walk in
    one batch), unaligned D (610, 1027, 4099: the scalar path), tiny_lm's
    shapes (C = 10 in f32: each warp owns its tiles), and D with tiles
    enough for each warp to own its own (2^20, 2^21)."""
    g, w2 = _inputs(c, d, 1, seed=13)
    g_t = torch.from_numpy(g).to(DTYPES[dtype][0]).to(cuda)
    w = torch.from_numpy(w2[0]).to(cuda)
    before = fwa.launch_counts()["fused_weighted_agg"]
    d_got, sq_got = fwa.fused_weighted_agg(g_t, w)
    d_want, sq_want = ref.weighted_agg_reference(g_t, w)
    torch.testing.assert_close(d_got, d_want, **(BF16_TOL if dtype == "bf16" else F32_TOL))
    torch.testing.assert_close(sq_got, sq_want, rtol=1e-4, atol=0.0)
    again = fwa.fused_weighted_agg(g_t, w)
    assert torch.equal(again[0], d_got) and torch.equal(again[1], sq_got)
    assert fwa.launch_counts()["fused_weighted_agg"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_cuda_dequant_on_two_streams(cuda, dtype):
    """Kernel 4's last block finds itself by the per-(device, stream) ticket
    counter it shares with kernel 2: launches on two streams at once give
    the bits of the same launches made in order."""
    g, w2 = _inputs(50, 114688, 2, seed=12)
    q, scales = fwa.quantize_stacked(torch.from_numpy(g).to(cuda), dtype=dtype)
    ws = [torch.from_numpy(w2[i]).to(cuda) for i in range(2)]
    lam = 0.1 * ws[1]
    want = [fwa.fused_dequant_cohort_agg(q, scales, w, lam) for w in ws]
    streams = [torch.cuda.Stream() for _ in ws]
    torch.cuda.synchronize()
    got = []
    for stream, w in zip(streams, ws):
        with torch.cuda.stream(stream):
            for _ in range(20):
                out = fwa.fused_dequant_cohort_agg(q, scales, w, lam)
            got.append(out)
    torch.cuda.synchronize()
    for outs, wants in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(outs, wants))


@pytest.mark.cuda
@pytest.mark.parametrize("c,d", [(10, 114688), (100, 610)])
def test_cuda_weighted_agg_on_two_streams(cuda, c, d):
    """Kernel 3's last block finds itself by the per-(device, stream) ticket
    counter it shares with kernels 2, 4 and 5: launches on two streams at
    once give the bits of the same launches made in order."""
    g, w2 = _inputs(c, d, 2, seed=14)
    g_t = torch.from_numpy(g).to(cuda)
    ws = [torch.from_numpy(w2[i]).to(cuda) for i in range(2)]
    want = [fwa.fused_weighted_agg(g_t, w) for w in ws]
    streams = [torch.cuda.Stream() for _ in ws]
    torch.cuda.synchronize()
    got = []
    for stream, w in zip(streams, ws):
        with torch.cuda.stream(stream):
            for _ in range(20):
                out = fwa.fused_weighted_agg(g_t, w)
            got.append(out)
    torch.cuda.synchronize()
    for outs, wants in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(outs, wants))
