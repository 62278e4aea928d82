"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel in ``fused_weighted_agg``,
``sharded_waterfill``, ``rmsnorm``, ``flash_attention`` or ``ssd_scan``
computes, with the arithmetic the JAX reference falls back to off the TPU
(``repro/core/estimator.py``: ``w2 @ flat`` and
``dequant_cohort_agg_reference``; ``repro/kernels/ref.py``:
``waterfill_stats_reference``, ``rmsnorm_reference``, ``mha_reference``;
``repro/kernels/ssd_scan.py``: the Pallas body's chunked math).  The
wrappers use them for tensors on the CPU, the tests hold them against the
JAX kernels run in interpret mode, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  ``ssd_reference`` is the sequential
oracle of the SSD scan, no kernel's plain version.
"""
from __future__ import annotations

import torch

__all__ = [
    "multi_weighted_agg_reference",
    "cohort_agg_and_error_reference",
    "weighted_agg_reference",
    "dequant_cohort_agg_reference",
    "waterfill_stats_reference",
    "rmsnorm_reference",
    "attention_mask",
    "mha_reference",
    "ssd_reference",
    "ssd_scan_reference",
]

NEG = -2.3819763e38  # the reference's bf16-safe -inf surrogate for masked logits


def multi_weighted_agg_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, C) weight rows x (C, D) stacked deltas -> (M, D) f32."""
    return w.to(torch.float32) @ g.to(torch.float32)


def cohort_agg_and_error_reference(
    g: torch.Tensor, w: torch.Tensor, lam_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, D) cohort deltas, weights w (C,) and lam_c (C,) ->
    (d = sum_c w_c g_c (D,) f32, ||sum_c (w_c - lam_c) g_c||^2 () f32)."""
    w = w.to(torch.float32)
    w2 = torch.stack([w, w - lam_c.to(torch.float32)])
    out = w2 @ g.to(torch.float32)
    return out[0], (out[1] ** 2).sum()


def weighted_agg_reference(g: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, D) stacked deltas, weights w (C,) -> (d = sum_c w_c g_c (D,) f32,
    per-row squared norms ||g_c||^2 (C,) f32)."""
    gf = g.to(torch.float32)
    return w.to(torch.float32) @ gf, (gf * gf).sum(1)


def dequant_cohort_agg_reference(
    q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor, lam_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise dequantization of q (C, D_pad) int8|fp8 with scales (C, nb)
    f32, then the (2, C) x (C, D_pad) contraction of [w, w - lam_c] and the
    per-row squared norms of the dequantized values.

    Returns (d (D_pad,) f32, ||sum_c (w_c - lam_c) g_c||^2 () f32,
    sq_norms (C,) f32)."""
    c, d_pad = q.shape
    nb = scales.shape[1]
    g = (q.to(torch.float32).reshape(c, nb, d_pad // nb) * scales[:, :, None]).reshape(c, d_pad)
    w = w.to(torch.float32)
    out = torch.stack([w, w - lam_c.to(torch.float32)]) @ g
    return out[0], (out[1] ** 2).sum(), (g * g).sum(1)


def waterfill_stats_reference(
    scores: torch.Tensor, levels: torch.Tensor, floors: torch.Tensor, chunk: int = 1 << 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scores (M,) f32 (+inf entries inert); levels / floors (L,) f32.

    Returns (n_below, n_floor, mid_sum), each (L,) f32:

      n_below[k] = #{a < levels[k]}
      n_floor[k] = #{a <= floors[k]}
      mid_sum[k] = sum of a over floors[k] < a < levels[k]

    Masked reductions over ``chunk`` scores at a time, so no (M, L)
    temporary is built; counts are summed as integers and exact."""
    lv, fl = levels[None, :], floors[None, :]
    n_below = torch.zeros(levels.shape[0], dtype=torch.int64, device=scores.device)
    n_floor = torch.zeros_like(n_below)
    mid = torch.zeros(levels.shape[0], dtype=torch.float32, device=scores.device)
    for start in range(0, scores.shape[0], chunk):
        a = scores[start : start + chunk, None]
        below = a < lv
        at_floor = a <= fl
        n_below += below.sum(0)
        n_floor += at_floor.sum(0)
        mid += torch.where(below & ~at_floor, a, 0.0).sum(0)
    return n_below.to(torch.float32), n_floor.to(torch.float32), mid


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (R, D), scale (D,) -> x * rsqrt(mean(x^2) + eps) * (1 + scale) in
    x.dtype, with f32 math."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def attention_mask(s_q: int, s_k: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S_q, S_k) bool, True where query i may read key j: j <= i when
    causal, j > i - window with a window."""
    qpos = torch.arange(s_q, device=device)[:, None]
    kpos = torch.arange(s_k, device=device)[None, :]
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_groups: int = 1,
) -> torch.Tensor:
    """q (..., H, S_q, hd); k, v (..., H / q_groups, S_k, hd), query head h
    reading key/value head h // q_groups.  Returns (..., H, S_q, hd) in
    q.dtype.

    Logits in f32 scaled by hd^-0.5, soft-capped before the mask, masked
    logits set to ``NEG`` (so a row masked everywhere averages v, as the
    reference's does), probabilities kept in f32 for the product with v."""
    if q_groups > 1:
        k = k.repeat_interleave(q_groups, dim=-3)
        v = v.repeat_interleave(q_groups, dim=-3)
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(q.shape[-2], k.shape[-2], causal, window, q.device)
    probs = torch.softmax(torch.where(mask, logits, NEG), dim=-1)
    return torch.matmul(probs, v.to(torch.float32)).to(q.dtype)


def ssd_reference(x: torch.Tensor, da: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The sequential SSD recurrence, one step a token (the definitionally
    correct scan):

      h_t = exp(da_t) h_{t-1} + x_t b_t^T,   y_t = h_t c_t

    x (B, S, hd) dt-weighted inputs of one head, da (B, S) log decays
    (negative), b, c (B, S, N).  Returns y (B, S, hd) in x.dtype and the
    final state (B, hd, N) f32."""
    xf, daf, bf, cf = (t.to(torch.float32) for t in (x, da, b, c))
    h = torch.zeros((x.shape[0], x.shape[2], b.shape[2]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = h * torch.exp(daf[:, t])[:, None, None] + xf[:, t, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h


def ssd_scan_reference(
    x: torch.Tensor,
    da: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """The SSD chunked scan with the Pallas body's math (kernel 8's plain
    version).  x (BH, S, hd) or (B, H, S, hd); da x.shape[:-1]; b, c (R, S, N)
    with R dividing BH: row i reads b[i // (BH / R)] (R = BH: a row each;
    R = B: B and C shared by the H heads of a batch row).

    Chunks of Q = min(chunk, S) steps, a ragged last one zero-padded (zero
    inputs and zero log decay leave y and the state unchanged).  Within a
    chunk, with cum the inclusive cumsum of da:

      y = (C B^T * exp(cum_t - cum_s) [s <= t]) X + (C * exp(cum)) S^T
      S <- exp(cum_last) S + (X * exp(cum_last - cum))^T B

    S (hd, N) f32 carried across chunks.  The mask is applied before the
    exp: above the diagonal cum_t - cum_s is positive and overflows f32 at
    strong decays.  Returns y (x's shape and dtype) and, with
    ``return_state``, the final state (BH, hd, N) f32."""
    s, hd = x.shape[-2:]
    r, n = b.shape[0], b.shape[-1]
    xf = x.reshape(-1, s, hd).to(torch.float32)
    g = xf.shape[0] // r
    xf = xf.reshape(r, g, s, hd)
    daf = da.reshape(r, g, s).to(torch.float32)
    bf = b.to(torch.float32)[:, None]
    cf = c.to(torch.float32)[:, None]
    q = min(int(chunk), s)
    n_chunks = -(-s // q)
    pad = n_chunks * q - s
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        daf = torch.nn.functional.pad(daf, (0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    above = ~torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((r, g, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n_chunks):
        sl = slice(i * q, (i + 1) * q)
        xq, dq, bq, cq = xf[:, :, sl], daf[:, :, sl], bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(dq, -1)
        decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(above, float("-inf")))
        y = ((cq @ bq.transpose(-1, -2)) * decay) @ xq
        ys.append(y + (cq * torch.exp(cum)[..., None]) @ state.transpose(-1, -2))
        w = torch.exp(cum[..., -1:] - cum)
        state = state * torch.exp(cum[..., -1])[..., None, None] + (xq * w[..., None]).transpose(-1, -2) @ bq
    y = torch.cat(ys, 2)[:, :, :s].reshape(x.shape).to(x.dtype)
    if return_state:
        return y, state.reshape(r * g, hd, n)
    return y
