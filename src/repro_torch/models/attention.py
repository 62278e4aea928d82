"""Grouped-query attention with RoPE, soft-capping, sliding windows, cached
decode and cross-attention (the port of ``repro/models/attention.py``).

Layout conventions, the reference's:
  activations    (B, S, d_model)
  q              (B, S, KV, G, hd)   G = n_heads / n_kv_heads
  k, v           (B, S, KV, hd)
  decode cache   {"k": (B, S_max, KV, hd), "v": ...}
  paged cache    {"pool_k": (B*P, page, KV, hd), "pool_v": ...,
                  "page_table": (B, P) int32}

Where the work goes:
  * full-sequence attention (prefill and training forward) runs kernel 7,
    ``kernels.ops.flash_attention``, on (B, heads, S, hd) views of q, k, v
    with ``q_groups = G``, whatever ``cfg.attn_impl`` says: self-attention
    (s_q = s_kv, causal with or without a window, or bidirectional as in
    whisper's encoder; softcap before the mask) and cross-attention (q from
    the tokens, k and v from the encoder's or the image's embeddings,
    s_q != s_kv, no RoPE and no mask);
  * decode attention (one query against the cache, masked past ``index``)
    and the decode step's cross-attention read of its fixed cross cache are
    plain torch (``_sdpa``), as the reference computes them in jnp outside
    any kernel.

The decode functions write the new K/V line into the cache in place (the
reference returns a new cache; the port's pool is preallocated once) and
return the same dict.  Under a mesh (``models/sharding.py``) the
reference's ``shard(...)`` annotations check the projections' layout;
``kv_heads`` stays whole (the rules keep it replicated), so attention runs
on gathered weights and whole heads.  A dense decode cache whose sequence
is split over a mesh line (``kv_seq``) is attended where it lies
(``split_decode_attention``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import sharding as msh
from repro_torch.models.common import ArchConfig, apply_rope, rms_norm, rope_angles, softcap, uniform_init

__all__ = [
    "init_attention",
    "attention",
    "cross_attention",
    "init_kv_cache",
    "decode_attention",
    "init_paged_kv_cache",
    "pack_kv_to_pages",
    "paged_decode_attention",
]

_NEG = -2.3819763e38  # bf16-safe -inf surrogate


def init_attention(cfg: ArchConfig, gen: torch.Generator | None, cross: bool = False) -> dict:
    hd = cfg.hd
    p = {
        "wq": uniform_init(gen, (cfg.d_model, cfg.n_heads * hd), cfg.param_dtype),
        "wk": uniform_init(gen, (cfg.d_model, cfg.n_kv_heads * hd), cfg.param_dtype),
        "wv": uniform_init(gen, (cfg.d_model, cfg.n_kv_heads * hd), cfg.param_dtype),
        "wo": uniform_init(gen, (cfg.n_heads * hd, cfg.d_model), cfg.param_dtype),
    }
    if cfg.qk_norm and not cross:
        dev = "meta" if gen is None else gen.device
        p["q_scale"] = torch.zeros((hd,), dtype=cfg.param_dtype, device=dev)
        p["k_scale"] = torch.zeros((hd,), dtype=cfg.param_dtype, device=dev)
    return p


def _project_qkv(params, cfg: ArchConfig, xq: torch.Tensor, xkv: torch.Tensor):
    b, s_q, _ = xq.shape
    s_kv = xkv.shape[1]
    hd = cfg.hd
    q = (xq @ params["wq"]).reshape(b, s_q, cfg.n_kv_heads, cfg.q_groups, hd)
    k = (xkv @ params["wk"]).reshape(b, s_kv, cfg.n_kv_heads, hd)
    v = (xkv @ params["wv"]).reshape(b, s_kv, cfg.n_kv_heads, hd)
    if "q_scale" in params:
        q = rms_norm(q, params["q_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_scale"], cfg.norm_eps)
    q = msh.shard(q, "batch", "seq", "kv_heads", None, None)
    k = msh.shard(k, "batch", "seq", "kv_heads", None)
    v = msh.shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def _kernel_attention(cfg: ArchConfig, q, k, v, *, causal: bool, window: int | None = None):
    """Full-sequence attention through kernel 7: q (B,S,KV,G,hd), k, v
    (B,S_kv,KV,hd) -> (B,S,KV,G,hd); S_kv may differ from S (cross-attention,
    ``causal=False``).  The kernel reads the (B, heads, S, hd) views in
    place and writes its output in q's (B, S, heads, hd) memory order, so
    the reshape back is free."""
    b, s, kv, g, hd = q.shape
    out = ops.flash_attention(
        q.reshape(b, s, kv * g, hd).transpose(1, 2),
        k.transpose(1, 2),
        v.transpose(1, 2),
        causal=causal,
        window=window,
        softcap=cfg.attn_softcap,
        q_groups=g,
    )
    return out.transpose(1, 2).reshape(b, s, kv, g, hd)


def _sdpa(cfg: ArchConfig, q, k, v, mask):
    """Plain masked attention for decode: q (B,Sq,KV,G,hd); k,v
    (B,Skv,KV,hd); mask broadcastable to (B,KV,G,Sq,Skv).  The reference's
    einsum path: f32 logits, probabilities cast to v's dtype for the
    product with v."""
    scale = cfg.hd**-0.5
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32), k.to(torch.float32)) * scale
    logits = softcap(logits, cfg.attn_softcap)
    if mask is not None:
        logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def _causal_mask(s_q: int, s_kv: int, window: int | None, offset: int = 0, device=None):
    """(1,1,1,Sq,Skv) bool; offset = absolute position of query 0."""
    qpos = torch.arange(s_q, device=device)[:, None] + offset
    kpos = torch.arange(s_kv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, None, None]


def _rope_qk(cfg: ArchConfig, q, k, rope):
    """Rotate q and k by ``rope`` = (cos, sin), each (S, hd/2): the tables
    of their positions (``rope_angles``)."""
    cos, sin = rope
    q = apply_rope(q, cos[None, :, None, None, :], sin[None, :, None, None, :])
    k = apply_rope(k, cos[None, :, None, :], sin[None, :, None, :])
    return q, k


def attention(params, cfg: ArchConfig, x: torch.Tensor, *, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill).  RoPE either way, as
    the reference's public ``attention`` does; whisper's encoder blocks take
    the unrotated bidirectional path of ``transformer._full_attention``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, x)
    q, k = _rope_qk(cfg, q, k, rope_angles(torch.arange(s, device=x.device), cfg.hd, cfg.rope_theta))
    out = _kernel_attention(cfg, q, k, v, causal=causal, window=window)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ params["wo"]


def cross_attention(params, cfg: ArchConfig, x: torch.Tensor, kv_source: torch.Tensor) -> torch.Tensor:
    """Cross-attention to encoder / image embeddings (no RoPE, no mask):
    x (B, S, d) attends to kv_source (B, S_src, d) through kernel 7."""
    return _cross_attention(params, cfg, x, kv_source)[0]


def _cross_attention(params, cfg: ArchConfig, x, kv_source):
    """``cross_attention`` and the cross K/V it used, (B, S_src, KV, hd)
    each: (out, k, v), for the prefill's cross cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, kv_source)
    out = _kernel_attention(cfg, q, k, v, causal=False)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ params["wo"], k, v


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, device=None) -> dict:
    dtype = dtype or cfg.param_dtype
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _decode_qkv(params, cfg: ArchConfig, x, index: int, rope):
    q, k_new, v_new = _project_qkv(params, cfg, x, x)
    if rope is None:
        rope = rope_angles(torch.arange(index, index + 1, device=x.device), cfg.hd, cfg.rope_theta)
    return (*_rope_qk(cfg, q, k_new, rope), v_new)


def decode_attention(params, cfg: ArchConfig, x: torch.Tensor, cache: dict, index: int, *,
                     window: int | None = None, rope=None, mask=None):
    """Single-token decode: x (B,1,d); the cache holds ``index`` valid
    tokens.  Writes position ``index`` of the cache in place.  ``rope``
    (position ``index``'s tables) and ``mask`` (``_causal_mask(1, S_max,
    window, index)``) may be passed in, computed once for all layers."""
    b = x.shape[0]
    index = int(index)
    q, k_new, v_new = _decode_qkv(params, cfg, x, index, rope)
    k, v = cache["k"], cache["v"]
    k[:, index] = k_new[:, 0].to(k.dtype)
    v[:, index] = v_new[:, 0].to(v.dtype)
    k = msh.shard(k, "batch", "kv_seq", None, None)
    v = msh.shard(v, "batch", "kv_seq", None, None)
    if mask is None:
        mask = _causal_mask(1, k.shape[1], window, index, x.device)
    out = _sdpa(cfg, q, k, v, mask)
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ params["wo"], cache


def split_decode_attention(params, cfg: ArchConfig, x: torch.Tensor, cache: dict, index: int,
                           group, *, window: int | None = None, rope=None):
    """``decode_attention`` on this rank's block of a cache whose sequence
    is split over ``group`` (block ``group.rank`` of ``S_max / size``
    positions): the rank that owns position ``index`` writes the new K/V
    line; each rank takes the logits of its positions (f32), and the max,
    the sum of exponentials and the weighted values are all_reduced over
    the line."""
    b = x.shape[0]
    index = int(index)
    q, k_new, v_new = _decode_qkv(params, cfg, x, index, rope)
    k, v = cache["k"], cache["v"]
    s_loc = k.shape[1]
    s0 = group.rank * s_loc
    if s0 <= index < s0 + s_loc:
        k[:, index - s0] = k_new[:, 0].to(k.dtype)
        v[:, index - s0] = v_new[:, 0].to(v.dtype)
    k = msh.shard(k, "batch", "kv_seq", None, None)
    v = msh.shard(v, "batch", "kv_seq", None, None)
    mask = _causal_mask(1, s_loc, window, index - s0, x.device)
    scale = cfg.hd**-0.5
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32), k.to(torch.float32)) * scale
    logits = torch.where(mask, softcap(logits, cfg.attn_softcap), _NEG)
    m = msh.all_reduce(logits.amax(-1, keepdim=True), group, "max")
    p = torch.exp(logits - m)
    den = msh.all_reduce(p.sum(-1, keepdim=True), group)  # (B, KV, G, 1, 1)
    num = msh.all_reduce(torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32)), group)
    out = (num / den.permute(0, 3, 1, 2, 4)).to(v.dtype)
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ params["wo"], cache


# ---------------------------------------------------------------------------
# paged decode cache (the serving layout)
# ---------------------------------------------------------------------------


def _pages_per_seq(max_seq: int, page_size: int) -> int:
    return -(-int(max_seq) // int(page_size))


def init_paged_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, page_size: int, dtype=None,
                        device=None) -> dict:
    """Preallocated paged KV cache: a (B*P, page, KV, hd) pool plus a (B, P)
    int32 page table (the identity table: each sequence a contiguous
    stripe)."""
    dtype = dtype or cfg.param_dtype
    pages = _pages_per_seq(max_seq, page_size)
    pool = (batch * pages, int(page_size), cfg.n_kv_heads, cfg.hd)
    table = torch.arange(batch * pages, dtype=torch.int32, device=device).reshape(batch, pages)
    return {
        "pool_k": torch.zeros(pool, dtype=dtype, device=device),
        "pool_v": torch.zeros(pool, dtype=dtype, device=device),
        "page_table": table,
    }


def pack_kv_to_pages(cache: dict, page_size: int) -> dict:
    """Repack a dense prefill cache {"k","v"}: (B, S_max, KV, hd) into the
    paged layout with the identity page table (the prefill -> decode
    hand-off)."""
    k, v = cache["k"], cache["v"]
    b, s_max, kv, hd = k.shape
    pages = _pages_per_seq(s_max, page_size)
    pad = pages * int(page_size) - s_max
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    table = torch.arange(b * pages, dtype=torch.int32, device=k.device).reshape(b, pages)
    return {
        "pool_k": k.reshape(b * pages, int(page_size), kv, hd),
        "pool_v": v.reshape(b * pages, int(page_size), kv, hd),
        "page_table": table,
    }


def paged_decode_attention(params, cfg: ArchConfig, x: torch.Tensor, cache: dict, index: int, *,
                           window: int | None = None, rope=None, mask=None):
    """Single-token decode against the paged cache (lockstep batch: every
    sequence writes position ``index``).

    The new K/V line lands in one (page, slot) per sequence, through the
    page table, in place.  Attention then gathers the table's view of the
    pool to (B, P*page, KV, hd) and runs the masked plain attention
    (positions past ``index``, the padded tail of the last page included,
    are masked, so pool garbage never contributes).  ``rope`` and ``mask``
    (``_causal_mask(1, P*page, window, index)``) may be passed in, computed
    once for all layers."""
    b = x.shape[0]
    index = int(index)
    pool_k, pool_v, table = cache["pool_k"], cache["pool_v"], cache["page_table"]
    page_size = pool_k.shape[1]
    q, k_new, v_new = _decode_qkv(params, cfg, x, index, rope)

    phys = table[:, index // page_size]  # (B,) int32 pool rows
    slot = index % page_size
    pool_k[phys, slot] = k_new[:, 0].to(pool_k.dtype)
    pool_v[phys, slot] = v_new[:, 0].to(pool_v.dtype)

    pages = table.shape[1]
    k = pool_k[table].reshape(b, pages * page_size, *pool_k.shape[2:])
    v = pool_v[table].reshape(b, pages * page_size, *pool_v.shape[2:])
    if mask is None:
        mask = _causal_mask(1, pages * page_size, window, index, x.device)
    out = _sdpa(cfg, q, k, v, mask)
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ params["wo"], cache
