"""Deployment realism: availability, deadline stragglers, buffered async.

Port of ``repro/core/stragglers.py``, the fault layer the round body runs
when a ``FaultSpec`` is enabled (``fed.server``).  In cross-device FL only a
subset A^t ~ q of clients is available each round; sampling from A^t and
importance-correcting by the availability probability keeps the estimate
unbiased (paper Appendix E.1):

    d^t = sum_{i in S^t subseteq A^t} lambda_i g_i / (q_i p_i)

Three components, each a function of (fault config, carried state, round,
draws), where the draws come from the run's random source
(``repro_torch.rng``):

1. **Availability** (``availability_step``): static Bernoulli(q), a
   per-client Markov on/off chain (the carried (N,) bool ``chain``) and a
   deterministic diurnal schedule.  ``q^t`` is the availability probability
   conditional on the carried chain, and ``available_draw`` composes it into
   the draw, so the plain estimator weights are the corrected ones.
2. **Deadline stragglers** (``latency_draw``, ``deadline_survival``): a
   per-client latency; clients past the deadline are dropped after their
   training was scheduled, and survivors are reweighted by
   ``1 / P(latency <= deadline)``.
3. **Buffered async** (``async_step``, ``flush_pending``): a carried (B, D)
   stale-delta ring; each round's aggregate arrives after a latency-derived
   delay and is applied with a ``staleness_discount ** staleness`` factor;
   what is still pending flushes once after the horizon.  With compression
   the ring holds int8 / fp8 codes and per-block scales.

Nothing here reads the device from the host during a round: the round index
is a Python int, the draws and the ring's bookkeeping are device tensors.
The sampler's own feedback update keeps using its marginals; availability is
exogenous.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.estimator import client_weights
from repro_torch.core.samplers import SampleResult
from repro_torch.fed.tasks import tree_leaves
from repro_torch.kernels.fused_weighted_agg import quant_dtype, quantize_stacked

__all__ = [
    "ZeroAvailabilityError",
    "available_draw",
    "availability_weights",
    "availability_init",
    "availability_step",
    "latency_draw",
    "deadline_survival",
    "fault_state_init",
    "abstract_fault_state",
    "async_step",
    "flush_pending",
    "flat_dim",
    "tree_to_vec",
    "vec_to_tree",
]


class ZeroAvailabilityError(ValueError):
    """A drawn client has availability probability q == 0: its contribution
    can never be observed and no finite importance weight corrects for it."""


def available_draw(
    draw: SampleResult, avail_mask: torch.Tensor, q: torch.Tensor | None = None
) -> SampleResult:
    """Restrict a draw to the available set A^t and, with ``q``, compose the
    availability probability into the draw's own probabilities.

    With ``q`` the returned ``marginals`` / ``draw_probs`` are the effective
    inclusion probabilities ``q * p``, so ``estimator.client_weights`` on the
    composed draw gives the corrected weights ``lam / (q p)``; clients with
    ``q == 0`` leave the mask, so their weight is zero.  Without ``q`` the
    probabilities are returned uncorrected (``availability_weights`` then
    applies the ``1/q`` factor)."""
    mask = draw.mask & avail_mask
    counts = torch.where(avail_mask, draw.counts, 0)
    if q is None:
        return SampleResult(mask=mask, counts=counts, marginals=draw.marginals,
                            draw_probs=draw.draw_probs)
    qf = q.to(torch.float32)
    return SampleResult(
        mask=mask & (qf > 0.0),
        counts=counts,
        marginals=qf * draw.marginals,
        draw_probs=qf * draw.draw_probs,
    )


def availability_weights(
    draw: SampleResult, lam: torch.Tensor, q: torch.Tensor, procedure: str, budget: int
) -> torch.Tensor:
    """Estimator weights with the 1/q availability correction, for a draw
    masked by ``available_draw(draw, avail)`` without ``q``.

    Host-side check: raises ``ZeroAvailabilityError`` when a drawn client
    has ``q == 0`` (it reads the mask back, so the round uses the composed
    ``available_draw(draw, avail, q)`` instead, as the reference does)."""
    q = q.to(torch.float32)
    w = client_weights(draw, lam, procedure, budget)
    bad = (draw.mask & (q <= 0.0)).cpu()
    if bool(bad.any()):
        raise ZeroAvailabilityError(
            f"clients {torch.nonzero(bad).flatten().tolist()} were drawn with "
            "availability probability q == 0; no finite importance weight "
            "corrects for a never-observable client"
        )
    return torch.where(q > 0.0, w / torch.where(q > 0.0, q, 1.0), 0.0)


# -- availability processes (FaultSpec.availability) --------------------------


def availability_init(fault, n: int, device) -> torch.Tensor | None:
    """The Markov chain's carried (N,) bool state, all on; None for the
    stateless processes."""
    if fault.availability == "markov":
        return torch.ones(n, dtype=torch.bool, device=device)
    return None


def availability_step(
    fault, chain: torch.Tensor | None, t: int, uniforms: torch.Tensor | None, n: int, device,
    block: tuple | None = None,
):
    """One round of the availability process, with ``uniforms`` the round's
    (N,) availability uniforms (None for ``diurnal``, which draws nothing).

    Returns ``(mask, q, new_chain)``: the (N,) bool availability mask, the
    (N,) f32 availability probability the 1/q correction uses (for the
    Markov chain conditional on the carried state) and the advanced chain
    (the mask itself; ``chain`` unchanged for the stateless processes).

    ``block=(lo, hi)``: a split client axis; ``chain`` and ``uniforms`` are
    the rank's block of clients ``lo .. hi - 1`` and so is every result."""
    mode = fault.availability
    kw = dict(fault.availability_kwargs)
    lo, hi = (0, n) if block is None else block
    if mode == "bernoulli":
        q = kw.get("q", 0.9)
        if isinstance(q, tuple):  # per client: a host table, copied without a sync
            q = torch.tensor(q[lo:hi], dtype=torch.float32).to(device, non_blocking=True)
        else:
            q = torch.full((hi - lo,), float(np.float32(q)), dtype=torch.float32, device=device)
        return uniforms < q, q, chain
    if mode == "markov":
        p_on = float(kw.get("p_on", 0.5))  # P(off -> on)
        p_off = float(kw.get("p_off", 0.5))  # P(on -> off)
        q = torch.where(chain, float(np.float32(1.0 - p_off)), float(np.float32(p_on)))
        mask = uniforms < q
        return mask, q, mask
    if mode == "diurnal":
        # Client i is on duty while the fractional phase of t / period + i / N
        # lies inside the duty cycle; q is the 0/1 mask itself (no finite
        # weight exists for an offline client).  The divisor is a device
        # tensor: a true f32 division, as the reference's.
        period = float(kw.get("period", 24.0))
        duty = float(kw.get("duty", 0.5))
        n_f = torch.full((), float(n), dtype=torch.float32, device=device)
        phase = torch.arange(lo, hi, dtype=torch.float32, device=device) / n_f
        frac = torch.remainder(float(np.float32(t) / np.float32(period)) + phase, 1.0)
        mask = frac < float(np.float32(duty))
        return mask, mask.to(torch.float32), chain
    raise ValueError(f"unknown availability process {mode!r}")


# -- latency / deadline stragglers (FaultSpec.deadline, .latency) -------------


def latency_draw(fault, standard: torch.Tensor) -> torch.Tensor:
    """Latencies from the spec's distribution, given standard variates of
    its family (``rng``): ``scale * Exp(1)``, ``U[lo, hi)`` from ``U[0, 1)``,
    or ``exp(mu + sigma * N(0, 1))``, in f32 as the reference computes them."""
    f32 = np.float32
    dist = fault.latency
    kw = dict(fault.latency_kwargs)
    if dist == "exponential":
        return float(f32(kw.get("scale", 1.0))) * standard
    if dist == "uniform":
        lo, hi = f32(kw.get("lo", 0.0)), f32(kw.get("hi", 1.0))
        return torch.clamp(standard * float(hi - lo) + float(lo), min=float(lo))
    if dist == "lognormal":
        mu, sigma = float(f32(kw.get("mu", 0.0))), float(f32(kw.get("sigma", 1.0)))
        return torch.exp(mu + sigma * standard)
    raise ValueError(f"unknown latency distribution {dist!r}")


def deadline_survival(fault) -> float:
    """P(latency <= deadline) as a build-time float: survivors' weights are
    rescaled by its inverse so deadline dropout stays unbiased.  Raises when
    it is (numerically) zero: every client would always miss the deadline."""
    d = float(fault.deadline)
    dist = fault.latency
    kw = dict(fault.latency_kwargs)
    if dist == "exponential":
        r = 1.0 - math.exp(-d / float(kw.get("scale", 1.0)))
    elif dist == "uniform":
        lo = float(kw.get("lo", 0.0))
        hi = float(kw.get("hi", 1.0))
        r = 1.0 if hi <= lo else min(max((d - lo) / (hi - lo), 0.0), 1.0)
        if hi <= lo and d < lo:
            r = 0.0
    elif dist == "lognormal":
        mu = float(kw.get("mu", 0.0))
        sigma = float(kw.get("sigma", 1.0))
        if d <= 0.0:
            r = 0.0
        else:
            r = 0.5 * (1.0 + math.erf((math.log(d) - mu) / (sigma * math.sqrt(2.0))))
    else:
        raise ValueError(f"unknown latency distribution {dist!r}")
    if r <= 1e-12:
        raise ValueError(
            f"deadline={d} gives survival probability ~{r:.3g} under "
            f"latency={dist!r} {dict(kw)}: every client always misses the "
            "deadline and no reweighting can keep the estimator unbiased"
        )
    return r


# -- the fault state the round carries ----------------------------------------


def fault_state_init(fault, n: int, d_dim: int, compression, device) -> dict:
    """The fault layer's carried state, a dict whose keys follow from the
    fault config:

    * ``chain``: (N,) bool Markov availability state (markov only);
    * ``buf``: the stale-delta ring (``async_buffer = B > 0`` only):
      ``delta`` (B, D) f32, ``dispatch`` / ``arrival`` (B,) int32 rounds and
      ``valid`` (B,) bool.  With compression ``delta`` is (B, D_pad) int8 or
      fp8 codes plus ``scale`` (B, nb) f32, as ``quantize_stacked`` writes
      them; the ring's quantization error is not fed back (a pending delta
      is a payload already sent)."""
    state: dict = {}
    chain = availability_init(fault, n, device)
    if chain is not None:
        state["chain"] = chain
    b = int(fault.async_buffer)
    if b > 0:
        buf = {
            "dispatch": torch.zeros(b, dtype=torch.int32, device=device),
            "arrival": torch.zeros(b, dtype=torch.int32, device=device),
            "valid": torch.zeros(b, dtype=torch.bool, device=device),
        }
        if compression is not None:
            sb = int(compression.scale_block)
            nb = -(-int(d_dim) // sb)
            buf["delta"] = torch.zeros(
                (b, nb * sb), dtype=quant_dtype(compression.delta_dtype), device=device
            )
            buf["scale"] = torch.ones((b, nb), dtype=torch.float32, device=device)
        else:
            buf["delta"] = torch.zeros((b, int(d_dim)), dtype=torch.float32, device=device)
        state["buf"] = buf
    return state


def abstract_fault_state(fault, n: int, d_dim: int = 0, compression=None) -> dict:
    """``fault_state_init``'s tensors on the ``meta`` device: their shapes
    and dtypes, no allocation."""
    return fault_state_init(fault, n, d_dim, compression, torch.device("meta"))


# -- buffered-asynchronous aggregation (FaultSpec.async_buffer) --------------


def _round_time(fault) -> float:
    rt = fault.round_time
    if rt is None:
        rt = fault.deadline
    return float(rt) if rt is not None else 1.0


def _ring_dequant_apply(
    delta: torch.Tensor, scale: torch.Tensor, coef: torch.Tensor
) -> torch.Tensor:
    """(B,) coefficients against a quantized ring: blockwise dequantize and
    contract, (B,) x (B, nb, sb) -> (D_pad,)."""
    b, d_pad = delta.shape
    nb = scale.shape[1]
    blocks = delta.to(torch.float32).reshape(b, nb, d_pad // nb)
    return torch.einsum("b,bns->ns", coef, blocks * scale[:, :, None]).reshape(d_pad)


def async_step(fault, buf: dict, u_vec: torch.Tensor, t: int, standard: torch.Tensor,
               compression=None):
    """One round of the stale-delta ring.

    The round's (D,) aggregate ``u_vec`` is written to slot ``t mod B`` with
    arrival round ``t + delay``, ``delay = floor(latency / round_time)``
    clipped to ``[0, B - 1]`` (so a slot is always drained before the ring
    reuses it); ``standard`` is the round's 0-d standard latency variate.
    Every buffered delta whose arrival round has come is applied with a
    ``staleness_discount ** (t - dispatch)`` factor.  With ``compression``
    the slot is quantized and arrived rows are dequantized in the
    contraction.  The input ring is not modified.

    Returns ``(new_buf, apply_vec (D,) f32, n_arrived () int32)``."""
    b = int(fault.async_buffer)
    rho = float(np.float32(fault.staleness_discount))
    # A device-tensor divisor: a true f32 division, as the reference's.
    rt = torch.full((), _round_time(fault), dtype=torch.float32, device=u_vec.device)
    lat = latency_draw(fault, standard)
    delay = torch.clamp(torch.floor(lat / rt).to(torch.int32), 0, b - 1)
    slot = t % b
    d_dim = u_vec.shape[0]
    delta = buf["delta"].clone()
    if compression is not None:
        q_row, s_row = quantize_stacked(
            u_vec[None, :], dtype=compression.delta_dtype,
            scale_block=int(compression.scale_block),
        )
        delta[slot] = q_row[0]
        scale = buf["scale"].clone()
        scale[slot] = s_row[0]
    else:
        delta[slot] = u_vec.to(torch.float32)
    # fill_ takes a host scalar as a kernel argument; assigning one would
    # copy it to the device and synchronize.
    dispatch = buf["dispatch"].clone()
    dispatch[slot].fill_(t)
    arrival = buf["arrival"].clone()
    arrival[slot] = t + delay
    valid = buf["valid"].clone()
    valid[slot].fill_(True)
    arrived = valid & (arrival <= t)
    disc = torch.pow(rho, (t - dispatch).to(torch.float32))
    coef = torch.where(arrived, disc, 0.0)
    new_buf = {"delta": delta, "dispatch": dispatch, "arrival": arrival, "valid": valid & ~arrived}
    if compression is not None:
        new_buf["scale"] = scale
        apply_vec = _ring_dequant_apply(delta, scale, coef)[:d_dim]
    else:
        apply_vec = coef @ delta
    return new_buf, apply_vec, arrived.to(torch.int32).sum()


def flush_pending(buf: dict, t_end: int, rho: float) -> torch.Tensor:
    """The staleness-discounted sum of every delta still pending when the
    horizon ends, (D,) f32, or (D_pad,) for a quantized ring (callers slice
    to D)."""
    disc = torch.pow(float(np.float32(rho)), (t_end - buf["dispatch"]).to(torch.float32))
    coef = torch.where(buf["valid"], disc, 0.0)
    if "scale" in buf:
        return _ring_dequant_apply(buf["delta"], buf["scale"], coef)
    return coef @ buf["delta"]


# -- flattened updates (the ring's D axis) ------------------------------------


def flat_dim(tree) -> int:
    """Total element count of a dict of tensors."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))


def tree_to_vec(tree) -> torch.Tensor:
    """Dict of tensors -> one (D,) f32 vector in the reference's leaf order
    (keys sorted at every level)."""
    return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in tree_leaves(tree)])


def vec_to_tree(vec: torch.Tensor, like):
    """(D,) vector -> dict (nested dicts and lists) shaped and typed like
    ``like`` (``tree_to_vec``'s inverse)."""
    off = 0

    def take(leaf):
        nonlocal off
        size = math.prod(leaf.shape)
        out = vec[off : off + size].reshape(leaf.shape).to(leaf.dtype)
        off += size
        return out

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return take(tree)

    return walk(like)
