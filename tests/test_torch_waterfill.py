"""Kernel 5's per-chunk algorithm (``csrc/sharded_waterfill.cu``), rehearsed
in plain torch on the CPU, against the JAX reference.

The CUDA kernel runs only on a GPU (``tests/test_torch_sharded.py``'s
``cuda`` tests hold it against the plain version there).  Its arithmetic is
rehearsed here step by step: chunks of Q scores staged with NaN past M;
order-preserving unsigned keys (NaN last); the chunk sorted only where it is
not already non-decreasing; the f64 base of each thread's run of 8 finite
values; two branch-free binary searches a level (``a < level``,
``a <= floor``); the middle sum as a difference of f64 prefixes, 0 where
``hi <= lo``, count times value where the middle entries are all equal, -inf
where they start at -inf; then the blocks' partials summed in groups of
about sqrt(n_blocks), counts as integers and sums in f64.  A single block
of at most 256 scores compares every level with every score instead, the
sum in f32 in index order.  The rehearsal is
held to ``repro.kernels.ref.waterfill_stats_reference`` and to the Pallas
kernel in interpret mode on the same numpy inputs: counts exact, mid_sum
within 1e-5 relative (another summation order).  ``edge_inputs`` builds the
cases the ``cuda`` tests share.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import waterfill_stats_reference as ref_stats  # noqa: E402
from repro.kernels.sharded_waterfill import waterfill_level_stats as ref_kernel  # noqa: E402
from repro_torch.kernels import sharded_waterfill  # noqa: E402

CHUNK, PER = 2048, 8  # the kernel's scores a block and a thread
SMALL = 256  # up to this many scores, the kernel's one block compares them all

CASES = ("sorted", "almost_sorted", "shuffled", "ties", "floors_ge_levels",
         "shuffled_levels", "special")


def edge_inputs(case: str, m: int, n_levels: int, seed: int, chunk: int = CHUNK):
    """(scores (m,), levels (L,), floors (L,)) f32 numpy for one case:
    sorted scores (the solve's input); sorted but one adjacent pair swapped
    in every chunk of ``chunk`` scores; shuffled; ties (scores from 40
    values, levels and floors equal to some of them); floors at or above
    their levels for half the ladder; a shuffled ladder; and -inf, NaN,
    +-0.0 and +inf scores with a ladder holding 0, -0.0, +-inf and NaN
    levels and floors."""
    rng = np.random.default_rng(seed)
    scores = rng.gamma(2.0, 1.0, size=m).astype(np.float32)
    levels = np.sort(rng.gamma(2.0, 1.0, size=n_levels)).astype(np.float32)
    floors = (levels * np.float32(0.05)).astype(np.float32)
    if case in ("sorted", "almost_sorted"):
        scores = np.sort(scores)
        if case == "almost_sorted":
            for i in range(chunk // 3, m - 1, chunk):
                scores[i], scores[i + 1] = scores[i + 1], scores[i]
    elif case == "ties":
        values = np.sort(rng.gamma(2.0, 1.0, size=40)).astype(np.float32)
        scores = rng.choice(values, size=m)
        levels = np.sort(rng.choice(values, size=n_levels))
        floors = rng.choice(values, size=n_levels)
    elif case == "floors_ge_levels":
        bump = rng.uniform(1.0, 2.0, size=n_levels).astype(np.float32)
        floors = np.where(np.arange(n_levels) % 2 == 0, levels * bump, floors).astype(np.float32)
        floors[1::4] = levels[1::4]
    elif case == "shuffled_levels":
        order = rng.permutation(n_levels)
        levels, floors = levels[order], floors[order]
    elif case == "special":
        n_special = max(m // 8, 1)
        picks = rng.permutation(m)[: 5 * n_special].reshape(5, -1)
        for row, value in zip(picks, (-np.inf, np.nan, 0.0, -0.0, np.inf)):
            scores[row] = value
        scores[: m // 4] *= -1.0  # negative scores too
        specials = [(0.0, -1.0), (-0.0, 0.0), (np.inf, 1.0), (1.0, -np.inf),
                    (2.0, np.nan), (np.nan, 0.5), (np.inf, np.inf), (-np.inf, -np.inf)]
        for k, (lv, fl) in enumerate(specials[:n_levels]):
            levels[k], floors[k] = lv, fl
    return (scores.astype(np.float32), levels.astype(np.float32), floors.astype(np.float32))


def _to_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving unsigned key (as int64), NaN the largest."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(torch.isnan(x), 0x7FFFFFFF, u)
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >= 0x80000000, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    return torch.where(u >= 0x80000000, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def _count_leading(s: torch.Tensor, pred, n: int) -> torch.Tensor:
    """The kernel's branch-free search for n levels at once: how many
    leading entries of the sorted chunk s satisfy pred (elementwise over the
    levels)."""
    pos = torch.zeros(n, dtype=torch.int64)
    step = s.shape[0] // 2
    while step > 0:
        pos = pos + torch.where(pred(s[pos + step - 1]), step, 0)
        step //= 2
    return pos + pred(s[pos]).to(torch.int64)


def _kernel_rehearsal(scores, levels, floors, chunk=CHUNK):
    """Kernel 5's arithmetic on torch CPU tensors.  Returns ((n_below,
    n_floor, mid_sum) f32, the number of chunks that took the sort)."""
    m, n_levels = scores.shape[0], levels.shape[0]
    n_blocks = -(-m // chunk)
    if n_blocks == 1 and m <= SMALL:  # each level against every score, f32 in order
        lv, fl, a = levels[None, :], floors[None, :], scores[:, None]
        mid = torch.where((a < lv) & ~(a <= fl), a, 0.0)
        out = ((a < lv).sum(0), (a <= fl).sum(0), torch.cumsum(mid, 0)[-1])
        return tuple(x.to(torch.float32) for x in out), 0
    parts, n_sorted = [], 0
    for b in range(n_blocks):
        x = torch.full((chunk,), float("nan"))
        x[: min(chunk, m - b * chunk)] = scores[b * chunk : (b + 1) * chunk]
        k = _to_key(x)
        if not bool((k[:-1] <= k[1:]).all()):
            k = torch.sort(k).values
            n_sorted += 1
        s = _from_key(k)
        runs = torch.where(torch.isfinite(s), s.double(), 0.0).reshape(-1, PER)
        base = torch.cat([torch.zeros(1, dtype=torch.float64), torch.cumsum(runs.sum(1), 0)])
        within = torch.zeros(runs.shape[0] + 1, PER, dtype=torch.float64)
        within[:-1, 1:] = torch.cumsum(runs, 1)[:, :-1]

        def prefix(i):
            return base[i // PER] + within[i // PER, i % PER]

        hi = _count_leading(s, lambda a: a < levels, n_levels)
        lo = _count_leading(s, lambda a: a <= floors, n_levels)
        first, last = s[lo.clamp(max=chunk - 1)], s[(hi - 1).clamp(min=0)]
        mid = torch.where(
            first == -math.inf, -math.inf,
            torch.where(first == last, (hi - lo).double() * first.double(), prefix(hi) - prefix(lo)),
        )
        parts.append((hi, lo, torch.where(hi > lo, mid, 0.0)))
    group = math.isqrt(n_blocks - 1) + 1  # the least g with g * g >= n_blocks
    groups = [parts[g : g + group] for g in range(0, n_blocks, group)]
    sums = [tuple(sum(p[i] for p in rows) for i in range(3)) for rows in groups]
    total = tuple(sum(p[i] for p in sums) for i in range(3))
    return tuple(t.to(torch.float32) for t in total), n_sorted


def _assert_stats(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize(
    "m,n_levels,chunk", [(300, 17, 64), (5000, 128, CHUNK), (2049, 9, 256), (200, 16, CHUNK)]
)
def test_rehearsal_matches_reference_and_pallas(case, m, n_levels, chunk):
    """The rehearsal at the kernel's chunk and at small chunks (several
    groups, M not a multiple of Q) against the JAX reference; against the
    Pallas kernel too where its +inf padding is inert (no +inf floor)."""
    scores, levels, floors = edge_inputs(case, m, n_levels, seed=m + n_levels, chunk=chunk)
    got, n_sorted = _kernel_rehearsal(*(torch.from_numpy(t) for t in (scores, levels, floors)),
                                      chunk=chunk)
    j = tuple(jnp.asarray(t) for t in (scores, levels, floors))
    _assert_stats([t.numpy() for t in got], ref_stats(*j))
    if not np.isposinf(floors).any():
        _assert_stats([t.numpy() for t in got], ref_kernel(*j, interpret=True))
    if case == "sorted":
        assert n_sorted == 0  # the solve's input never takes the sort
    if case in ("almost_sorted", "shuffled") and m > SMALL:
        assert n_sorted >= 1


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_on_edges(case):
    """The port's plain version (the CPU wrapper, ``kernels/ref.py``) treats
    ties, NaN, -inf, +-0.0 and floors at or above their levels as the Pallas
    kernel does (+inf floors left out: the Pallas wrapper pads with +inf)."""
    scores, levels, floors = edge_inputs(case, 1000, 16, seed=5)
    floors = np.where(np.isposinf(floors), np.float32(3.0), floors)
    got = sharded_waterfill.waterfill_level_stats(
        *(torch.from_numpy(t) for t in (scores, levels, floors)))
    want = ref_kernel(*(jnp.asarray(t) for t in (scores, levels, floors)), interpret=True)
    _assert_stats([t.numpy() for t in got], want)


def test_keys_order_floats_and_round_trip():
    """The keys order floats as they compare (-0.0 just before +0.0), NaN of
    either sign last, and map back to the same bits (NaN to one NaN)."""
    x = torch.tensor([-math.inf, -3.5, -1e-45, -0.0, 0.0, 1e-45, 2.0, math.inf, math.nan,
                      -math.nan])
    k = _to_key(x)
    assert bool((k[:-2] < k[1:-1]).all()) and int(k[-1]) == int(k[-2]) == 0xFFFFFFFF
    back = _from_key(k)
    assert torch.equal(back[:-2].view(torch.int32), x[:-2].view(torch.int32))
    assert bool(torch.isnan(back[-2:]).all())
