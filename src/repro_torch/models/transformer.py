"""Model assembly for every family of the zoo (the port of
``repro/models/transformer.py``, block kinds ``attn``, ``attn_local``,
``moe``, ``mamba2``, ``shared_attn``, ``mlstm``, ``slstm``, ``cross_attn``
and ``dec``, and the ``enc`` blocks of whisper's encoder).

The parameter tree keeps the reference's names and stacked layout: each
pattern slot j holds its blocks' leaves in ``params["stacks"][j]`` with a
leading repeats axis, and the forward loops over repeats in Python (the
reference scans them).  A ``shared_attn`` slot holds no weights (``{}``): its
blocks run the one ``attn`` block stored once in ``params["shared"]``, each
invocation with a cache of its own (zamba2).  Three modes share the blocks:

  train   (``forward``)     full sequence, no caches   -> logits, aux
  prefill (``prefill``)     full sequence, caches out  -> last logits, caches
  decode  (``decode_step``) one token, caches updated  -> logits, caches

``aux`` is the MoE load-balance loss summed over the ``moe`` blocks (zero
for the other families).  Caches mirror the slots, stacked over repeats:
K/V for the self-attention kinds (``moe`` included), the recurrent {"conv",
"ssm"} state for ``mamba2`` and the {"c", "n", "m", ...} states for
``mlstm`` and ``slstm`` (never paged), the fixed-width cross K/V {"k", "v"}
(B, frontend_seq, KV, hd) for ``cross_attn`` and {"self": K/V, "cross":
{"k", "v"}} for ``dec`` (only the self half is paged).  An
``mlstm``/``slstm`` prefill is the decode cell run over the prompt a token
at a time, after one ``ln1`` norm over the whole sequence (the reference's
``_recurrent_prefill``).

The frontend archs (the vlm and whisper) take ``aux_embeds``, the stubbed
frontend's output (B, frontend_seq, frontend_dim) f32, in ``forward``,
``loss_fn`` (a third batch entry) and ``prefill``: whisper runs its encoder
over them (``_encode``: the projection, learned positions, ``enc`` blocks
with bidirectional attention and no RoPE, a final norm), the vlm projects
them (``_cross_source``).  A ``cross_attn`` block adds ``tanh(gate)`` times
its cross-attention (the gate is zero at init); a ``dec`` block runs causal
self-attention, then cross-attention, then an ungated MLP.  A decode step
reads the cross K/V from the cache and takes no ``aux_embeds``.  Without
them ``forward`` and ``prefill`` of a frontend arch raise ``ValueError``.

Every ``rms_norm`` is one launch of kernel 6: two a block plus the final
norm (a ``mamba2`` block's two are its input norm and its gated norm over
d_in, an xLSTM block's its input norm and its inner norm, a ``moe`` block
with ``qk_norm`` adds the q and k norms, four a block); every
full-sequence attention one launch of kernel 7 and every ``mamba2`` block
in ``forward`` and ``prefill`` one launch of kernel 8.  A ``dec`` block
adds its ``lnx`` norm and its cross-attention (three kernel-6 and two
kernel-7 launches), whisper's encoder ``2 E + 1`` kernel-6 and ``E``
kernel-7 launches.  A decode step launches kernel 6 as often as a forward
(the decoder's part of it) and kernels 7 and 8 never; an xLSTM prefill of S
tokens launches kernel 6 ``L * (1 + S) + 1`` times.
``params_from_reference`` turns the JAX reference's ``init_params`` tree
(numpy leaves) into the port's tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fed.tasks import tree_leaves
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (
    _causal_mask,
    _kernel_attention,
    _project_qkv,
    _rope_qk,
    init_attention,
)
from repro_torch.models.common import ArchConfig, rms_norm, rope_angles, softcap, uniform_init
from repro_torch.models.mlp import init_mlp, mlp

__all__ = [
    "init_params",
    "params_from_reference",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_caches",
    "param_count",
]

MOE_AUX_COEF = 0.01
REMAT_MODES = ("full", "none")  # the reference's ArchConfig.remat values

PORTED_KINDS = ("attn", "attn_local", "moe", "mamba2", "shared_attn", "mlstm", "slstm",
                "cross_attn", "dec")  # "enc" blocks live in params["encoder"] alone
ATTN_KINDS = ("attn", "attn_local", "moe", "shared_attn")  # flat self-attention K/V caches
_RECURRENT = {  # kind: (decode step, state init)
    "mlstm": (xlstm_mod.mlstm_decode_step, xlstm_mod.init_mlstm_state),
    "slstm": (xlstm_mod.slstm_decode_step, xlstm_mod.init_slstm_state),
}


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(kind: str, cfg: ArchConfig, gen: torch.Generator | None) -> dict:
    """One block of ``kind`` (``attn`` and ``attn_local`` share a layout,
    ``moe`` swaps the MLP for the expert FFN; ``shared_attn`` has no weights
    of its own; ``cross_attn`` adds a scalar ``gate``; ``enc`` and ``dec``
    have ungated MLPs, ``dec`` a cross-attention ``xattn`` after its
    norm ``lnx``)."""
    dev = "meta" if gen is None else gen.device
    d, dt = cfg.d_model, cfg.param_dtype
    ln1 = torch.zeros((d,), dtype=dt, device=dev)
    if kind == "dec":
        return {"ln1": ln1, "attn": init_attention(cfg, gen),
                "lnx": torch.zeros((d,), dtype=dt, device=dev),
                "xattn": init_attention(cfg, gen, cross=True),
                "ln2": torch.zeros((d,), dtype=dt, device=dev),
                "mlp": init_mlp(cfg, gen, gated=False)}
    if kind == "mamba2":
        return {"ln1": ln1, "ssm": ssm_mod.init_mamba2(cfg, gen)}
    if kind == "mlstm":
        return {"ln1": ln1, "cell": xlstm_mod.init_mlstm(cfg, gen)}
    if kind == "slstm":
        return {"ln1": ln1, "cell": xlstm_mod.init_slstm(cfg, gen)}
    if kind == "shared_attn":
        return {}
    block = {"ln1": ln1, "attn": init_attention(cfg, gen, cross=(kind == "cross_attn")),
             "ln2": torch.zeros((d,), dtype=dt, device=dev)}
    if kind == "moe":
        block["moe"] = moe_mod.init_moe(cfg, gen)
    else:
        block["mlp"] = init_mlp(cfg, gen, gated=(kind != "enc"))
    if kind == "cross_attn":  # llama-vision's gated cross-attention
        block["gate"] = torch.zeros((), dtype=dt, device=dev)
    return block


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if len(trees) == 1:  # a view: no second copy of a one-repeat stack (arctic's experts)
        return trees[0].unsqueeze(0)
    return torch.stack(trees)


def _init_tree(cfg: ArchConfig, gen: torch.Generator | None) -> dict:
    for kind in cfg.block_pattern:
        _check_kind(kind)
    reps = cfg.pattern_repeats()
    dev = "meta" if gen is None else gen.device
    params = {
        "embed": uniform_init(gen, (cfg.vocab, cfg.d_model), cfg.param_dtype, scale=0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=dev),
        "stacks": [
            _stack([_init_block(kind, cfg, gen) for _ in range(reps)]) for kind in cfg.block_pattern
        ],
    }
    if "shared_attn" in cfg.block_pattern:
        params["shared"] = _init_block("attn", cfg, gen)
    if cfg.encoder_layers:
        params["encoder"] = {
            "pos": uniform_init(gen, (cfg.frontend_seq, cfg.d_model), cfg.param_dtype, scale=0.02),
            "stack": _stack([_init_block("enc", cfg, gen) for _ in range(cfg.encoder_layers)]),
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=dev),
        }
    if cfg.frontend:
        fd = cfg.frontend_dim or cfg.d_model
        params["frontend_proj"] = uniform_init(gen, (fd, cfg.d_model), cfg.param_dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = uniform_init(gen, (cfg.d_model, cfg.vocab), cfg.param_dtype, scale=0.02)
    return params


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device=None) -> dict:
    """Fresh weights drawn from ``gen`` (a generator on ``device``; the GPU
    unless the caller asks for the CPU).  The reference's initializers and
    scales; other numbers than the reference's threefry draws.  With
    ``device="meta"`` and no generator: the tree's shapes and dtypes as
    ``meta`` tensors, no weights made (the lint's abstract parameters)."""
    if gen is None and str(device) == "meta":
        return _init_tree(cfg, None)
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the parameters go to {dev}")
    return _init_tree(cfg, gen)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.array(x, copy=True, order="C")  # writable: jax's host arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch.from_numpy refuses it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree, cfg: ArchConfig, device=None) -> dict:
    """The JAX reference's ``init_params(cfg, key)`` tree, with numpy (or
    array-like) leaves, as the port's tree, name for name; shapes and dtypes
    are checked against what ``init_params`` builds for ``cfg``."""
    dev = resolve_device(device)
    want = _init_tree(cfg, None)

    def conv(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"params_from_reference: {path or 'root'} has {got}, expected {sorted(spec)}")
            return {k: conv(node[k], spec[k], f"{path}[{k!r}]") for k in spec}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise ValueError(f"params_from_reference: {path} must be a list of {len(spec)} slots")
            return [conv(n, s, f"{path}[{i}]") for i, (n, s) in enumerate(zip(node, spec))]
        t = _to_tensor(node, dev)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(
                f"params_from_reference: {path} is {tuple(t.shape)}/{t.dtype}, expected "
                f"{tuple(spec.shape)}/{spec.dtype}"
            )
        return t

    return conv(tree, want, "")


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _rep(tree, r: int):
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree, reps: int) -> list:
    """A stacked slot as ``reps`` per-repeat trees of views.  One
    ``torch.unbind`` a leaf: its backward stacks the repeats' gradients
    once, where indexing one repeat at a time (``_rep``) would give each
    layer's gradient as a zero-filled copy of the whole stack, summed over
    the repeats (O(repeats) stack-sized fills and adds a leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(reps)]
    return list(torch.unbind(tree, 0))


def _full_attention(p, cfg: ArchConfig, x, rope, *, causal=True, window=None, want_cache=False,
                    max_seq=None):
    """Self-attention over the whole sequence; RoPE only on the causal
    (decoder) kind: whisper's bidirectional encoder has learned positions."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, x)
    if causal:
        q, k = _rope_qk(cfg, q, k, rope)
    out = _kernel_attention(cfg, q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    cache = None
    if want_cache:
        if max_seq is not None and max_seq > s:
            pad = (0, 0, 0, 0, 0, max_seq - s)
            k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        cache = {"k": k, "v": v}
    return out, cache


def _cross_attention(p, cfg: ArchConfig, x, src, want_cache=False):
    """Cross-attention of x (B, S, d) to src (B, S_src, d) through kernel 7;
    with ``want_cache`` also the cross K/V {"k", "v"} (B, S_src, KV, hd)."""
    out, k, v = attn_mod._cross_attention(p, cfg, x, src)
    return out, ({"k": k, "v": v} if want_cache else None)


def _cross_from_cache(p, cfg: ArchConfig, x, cache):
    """A decode step's cross-attention: the query against the cross K/V
    the prefill stored, in plain torch (``_sdpa``, no mask)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_kv_heads, cfg.q_groups, cfg.hd)
    out = attn_mod._sdpa(cfg, q, cache["k"], cache["v"], None)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]


def _decode_attn(p, cfg: ArchConfig, x, cache, index, rope, masks: dict, *, window=None):
    """The paged cache (the serving engine's pool + page table) routes to
    ``paged_decode_attention``, the dense layout to ``decode_attention``.
    ``masks`` memoizes the step's decode mask per window across layers."""
    paged = "page_table" in cache
    if window not in masks:
        n_keys = cache["page_table"].shape[1] * cache["pool_k"].shape[1] if paged else cache["k"].shape[1]
        masks[window] = _causal_mask(1, n_keys, window, index, x.device)
    fn = attn_mod.paged_decode_attention if paged else attn_mod.decode_attention
    return fn(p, cfg, x, cache, index, window=window, rope=rope, mask=masks[window])


def _recurrent_prefill(step_fn, state, x):
    """Fold the prompt x (B, S, d) into the recurrent ``state`` a token at a
    time with the decode cell (which updates ``state`` in place); returns
    the per-token outputs (B, S, d) and the state."""
    ys = []
    for t in range(x.shape[1]):
        y, state = step_fn(x[:, t : t + 1], state)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1), state


def _apply_block(kind: str, p: dict, cfg: ArchConfig, h, rope, *, mode: str, cache=None,
                 index=None, max_seq=None, masks=None, shared=None, cross_src=None):
    """Returns (h, new_cache, aux): aux the block's MoE load-balance loss
    (None for the other kinds).  ``rope``: the (cos, sin) tables of the
    positions this call processes, shared by every layer.  ``shared_attn``
    runs the ``attn`` block ``shared`` with this invocation's cache; a
    recurrent decode (``mamba2``, ``mlstm``, ``slstm``) updates its cache
    in place.  ``cross_src``: the cross-attention source (B, S_src, d) of
    ``cross_attn`` and ``dec`` in train and prefill; decode reads the
    cross cache."""
    if kind == "shared_attn":
        return _apply_block("attn", shared, cfg, h, rope, mode=mode, cache=cache, index=index,
                            max_seq=max_seq, masks=masks)
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if kind == "enc":
        y, _ = _full_attention(p["attn"], cfg, x, None, causal=False)
        h = h + y
        return h + mlp(p["mlp"], cfg, rms_norm(h, p["ln2"], cfg.norm_eps)), None, None
    if kind == "cross_attn":
        if mode == "decode":
            y = _cross_from_cache(p["attn"], cfg, x, cache)
        else:
            y, cache = _cross_attention(p["attn"], cfg, x, cross_src, want_cache=(mode == "prefill"))
        h = h + torch.tanh(p["gate"]).to(h.dtype) * y
        return h + mlp(p["mlp"], cfg, rms_norm(h, p["ln2"], cfg.norm_eps)), cache, None
    if kind == "dec":
        if mode == "decode":
            y, self_cache = _decode_attn(p["attn"], cfg, x, cache["self"], index, rope, masks)
        else:
            y, self_cache = _full_attention(p["attn"], cfg, x, rope,
                                            want_cache=(mode == "prefill"), max_seq=max_seq)
        h = h + y
        x = rms_norm(h, p["lnx"], cfg.norm_eps)
        if mode == "decode":
            y, cross_cache = _cross_from_cache(p["xattn"], cfg, x, cache["cross"]), cache["cross"]
        else:
            y, cross_cache = _cross_attention(p["xattn"], cfg, x, cross_src,
                                              want_cache=(mode == "prefill"))
        h = h + y
        new_cache = None if mode == "train" else {"self": self_cache, "cross": cross_cache}
        return h + mlp(p["mlp"], cfg, rms_norm(h, p["ln2"], cfg.norm_eps)), new_cache, None
    if kind == "mamba2":
        if mode == "decode":
            y, cache = ssm_mod.mamba2_decode_step(p["ssm"], cfg, x, cache)
        elif mode == "prefill":
            y, cache = ssm_mod.mamba2_block(p["ssm"], cfg, x, return_state=True)
        else:
            y = ssm_mod.mamba2_block(p["ssm"], cfg, x)
        return h + y, cache, None
    if kind in _RECURRENT:
        step, init_state = _RECURRENT[kind]
        if mode == "decode":
            y, cache = step(p["cell"], cfg, x, cache)
        elif mode == "prefill":
            state0 = init_state(cfg, x.shape[0], device=x.device)
            y, cache = _recurrent_prefill(lambda tok, st: step(p["cell"], cfg, tok, st), state0, x)
        else:
            block = xlstm_mod.mlstm_block if kind == "mlstm" else xlstm_mod.slstm_block
            y = block(p["cell"], cfg, x)
        return h + y, cache, None
    window = cfg.sliding_window if kind == "attn_local" else None
    if mode == "decode":
        y, cache = _decode_attn(p["attn"], cfg, x, cache, index, rope, masks, window=window)
    else:
        y, cache = _full_attention(
            p["attn"], cfg, x, rope, window=window, want_cache=(mode == "prefill"), max_seq=max_seq
        )
    h = h + y
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        y, aux = moe_mod.moe_ffn(p["moe"], cfg, x)
        return h + y, cache, aux
    return h + mlp(p["mlp"], cfg, x), cache, None


def _remat_on(cfg: ArchConfig) -> bool:
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"{cfg.name}: remat must be one of {REMAT_MODES}, got {cfg.remat!r}")
    return cfg.remat == "full"


def _run_stack(params, cfg: ArchConfig, h, *, mode, caches=None, index=None, max_seq=None,
               cross_src=None):
    """Loop over the pattern groups; returns (h, aux, caches).  caches: per
    slot, stacked over repeats (decode updates them in place); prefill
    returns new ones.  aux: the MoE losses summed within each pattern group,
    then over the groups (the reference's order), or None without a
    ``moe`` block.  The RoPE tables (and in decode the masks) are the same
    for every layer, so they are computed once per call (the reference's
    XLA program shares them the same way).  In training with
    ``cfg.remat == "full"`` each pattern group runs through
    ``remat.recompute``, the RoPE tables, ``shared`` and the cross source
    entering it as inputs: the backward recomputes the group's forward
    (kernels 6-8 launch again there) and keeps only its input."""
    for kind in cfg.block_pattern:
        _check_kind(kind)
    reps = cfg.pattern_repeats()
    if mode == "decode":
        pos = torch.arange(index, index + 1, device=h.device)
    else:
        pos = torch.arange(h.shape[1], device=h.device)
    rope = rope_angles(pos, cfg.hd, cfg.rope_theta)
    masks: dict = {}
    out_caches = [[] for _ in cfg.block_pattern]
    layers = [_unstack(stack, reps) for stack in params["stacks"]]
    remat = mode == "train" and _remat_on(cfg)

    def group(h, blocks, shared, cross_src, rope, r=None):
        aux_sum = None
        for j, kind in enumerate(cfg.block_pattern):
            cache = None if r is None or caches is None else _rep(caches[j], r)
            h, nc, aux = _apply_block(
                kind, blocks[j], cfg, h, rope, mode=mode, cache=cache,
                index=index, max_seq=max_seq, masks=masks, shared=shared,
                cross_src=cross_src,
            )
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
            if r is not None:
                out_caches[j].append(nc)
        return h, aux_sum

    group_aux = []
    for r in range(reps):
        blocks = [layers[j][r] for j in range(len(cfg.block_pattern))]
        args = (h, blocks, params.get("shared"), cross_src, rope)
        # The reference's jax.checkpoint of its scan body: a pattern group's
        # activations are recomputed in the backward, not kept.
        h, aux_sum = remat_mod.recompute(group, *args) if remat else group(*args, r=r)
        if aux_sum is not None:
            group_aux.append(aux_sum)
    aux = torch.stack(group_aux).sum() if group_aux else None
    if mode == "prefill":
        return h, aux, [_stack(c) for c in out_caches]
    return h, aux, caches


def _embed(params, cfg: ArchConfig, tokens):
    # F.embedding, not params["embed"][tokens]: under vmap(grad) the
    # indexing backward sums repeated tokens in a thread-dependent order, so
    # two federated runs of one spec would differ in the last bits.
    h = torch.nn.functional.embedding(tokens, params["embed"])
    if cfg.scale_embed:
        # sqrt(d_model) rounded to h's dtype first, as the reference does; a
        # host scalar, so no host-to-device copy.
        h = h * float(torch.tensor(cfg.d_model**0.5, dtype=h.dtype))
    return h


def _encode(params, cfg: ArchConfig, frames):
    """Whisper's encoder over the stubbed post-convolution features frames
    (B, S_frames, frontend_dim): the frontend projection, learned
    positions, the ``enc`` blocks, the encoder's final norm."""
    enc = params["encoder"]
    h = frames.to(cfg.param_dtype) @ params["frontend_proj"] + enc["pos"][None]
    for blk in _unstack(enc["stack"], cfg.encoder_layers):
        h, _, _ = _apply_block("enc", blk, cfg, h, None, mode="train")
    return rms_norm(h, enc["final_norm"], cfg.norm_eps)


def _cross_source(params, cfg: ArchConfig, aux_embeds):
    """The cross-attention source from the stubbed frontend embeddings:
    whisper's encoder output, or the vlm's projected patches.  A frontend
    arch without them raises ``ValueError`` (the reference fails later, on
    ``None``)."""
    if aux_embeds is None:
        if cfg.frontend:
            raise ValueError(
                f"{cfg.name} needs its frontend embeddings: pass aux_embeds "
                f"(B, {cfg.frontend_seq}, {cfg.frontend_dim or cfg.d_model}) f32, the "
                f"stubbed {cfg.frontend} frontend's output"
            )
        return None
    if cfg.encoder_layers:
        return _encode(params, cfg, aux_embeds)
    return aux_embeds.to(cfg.param_dtype) @ params["frontend_proj"]


def _head(params, cfg: ArchConfig, h):
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return softcap(h @ head, cfg.final_softcap)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, aux_embeds=None):
    """Training forward: tokens (B, S) [+ aux_embeds (B, S_front, F)] ->
    (logits (B,S,V), aux_loss)."""
    h = _embed(params, cfg, tokens)
    cross_src = _cross_source(params, cfg, aux_embeds)
    h, aux, _ = _run_stack(params, cfg, h, mode="train", cross_src=cross_src)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _head(params, cfg, h), aux


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """batch: (tokens, targets) or (tokens, targets, aux_embeds).  Mean
    next-token cross-entropy in f32 plus
    ``MOE_AUX_COEF`` times the MoE load-balance loss (zero without ``moe``
    blocks)."""
    tokens, targets = batch[0], batch[1]
    logits, aux = forward(params, cfg, tokens, batch[2] if len(batch) > 2 else None)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold) + MOE_AUX_COEF * aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, page_size: int | None = None, *,
                device=None):
    """Zeroed caches (stacked over pattern repeats) for decode; ``page_size``
    switches the attention caches to the paged layout
    (``attention.init_paged_kv_cache``).  The recurrent states (Mamba2,
    mLSTM, sLSTM) and the fixed-width cross caches are O(1) in the sequence
    and are never paged.  ``device="meta"``: shapes and dtypes only (the
    dry run's caches)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    reps = cfg.pattern_repeats()

    def kv_cache():
        if page_size is not None:
            return attn_mod.init_paged_kv_cache(cfg, batch, max_seq, page_size, device=dev)
        return attn_mod.init_kv_cache(cfg, batch, max_seq, device=dev)

    def one(kind):
        _check_kind(kind)
        if kind in ("cross_attn", "dec"):
            c = attn_mod.init_kv_cache(cfg, batch, cfg.frontend_seq, device=dev)
            if kind == "dec":
                c = {"self": kv_cache(), "cross": c}
        elif kind == "mamba2":
            c = ssm_mod.init_mamba2_state(cfg, batch, device=dev)
        elif kind in _RECURRENT:
            c = _RECURRENT[kind][1](cfg, batch, device=dev)
        else:
            c = kv_cache()
        return _stack([c] * reps)

    return [one(kind) for kind in cfg.block_pattern]


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, aux_embeds=None, max_seq=None,
            page_size: int | None = None):
    """Process the prompt [and the frontend embeddings], return (logits (B,
    1, V), caches).  Self-attention caches are padded to ``max_seq``
    (default: the prompt length); with ``page_size`` they are repacked into
    the paged decode layout."""
    h = _embed(params, cfg, tokens)
    cross_src = _cross_source(params, cfg, aux_embeds)
    h, _, caches = _run_stack(params, cfg, h, mode="prefill", max_seq=max_seq, cross_src=cross_src)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _head(params, cfg, h[:, -1:])
    if page_size is not None:
        caches = _caches_to_pages(cfg, caches, page_size)
    return logits, caches


def _caches_to_pages(cfg: ArchConfig, caches, page_size: int):
    """Repack every self-attention slot cache (stacked over repeats) into the
    paged layout: a flat K/V cache of ``ATTN_KINDS`` and the self half of a
    ``dec`` cache; recurrent and cross caches pass through."""

    def pack(cache):
        return _stack([
            attn_mod.pack_kv_to_pages({"k": cache["k"][r], "v": cache["v"][r]}, page_size)
            for r in range(cache["k"].shape[0])
        ])

    out = []
    for kind, cache in zip(cfg.block_pattern, caches):
        if kind in ATTN_KINDS:
            out.append(pack(cache))
        elif kind == "dec":
            out.append({"self": pack(cache["self"]), "cross": cache["cross"]})
        else:
            out.append(cache)
    return out


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches, index: int):
    """token (B, 1) int; index = number of tokens already in the cache (a
    host integer).  Updates ``caches`` in place and returns them."""
    h = _embed(params, cfg, token)
    h, _, caches = _run_stack(params, cfg, h, mode="decode", caches=caches, index=int(index))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h), caches
