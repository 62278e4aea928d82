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
{"k", "v"}} for ``dec`` (only the self half is paged).  An ``slstm``
prefill is the decode cell run over the prompt a token at a time, after
one ``ln1`` norm over the whole sequence (the reference's
``_recurrent_prefill``); an ``mlstm`` prefill computes the same function
with its projections and inner norm run once over the prompt
(``xlstm.mlstm_prefill``).

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
tokens launches kernel 6 twice an ``mlstm`` block, ``1 + S`` times an
``slstm`` block and once more for the final norm.
``params_from_reference`` turns the JAX reference's ``init_params`` tree
(numpy leaves) into the port's tree.

Under ``models.sharding.use_rules`` over a mesh of more than one rank the
functions run one rank's share (``models/sharding.py``): ``params`` are its
blocks (``launch/sharding.py:param_shardings``); each pattern group, the
``shared`` block, the encoder and the frontend projection gather their
leaves at use, but the MLP's hidden units and the experts, which
``models/mlp.py`` and ``models/moe.py`` compute split, and the
projections of a ``mamba2`` or ``mlstm`` block whose heads the ``model``
line divides, which ``models/ssm.py`` and ``models/xlstm.py`` compute on
this rank's heads (the ``state`` rule) in training, prefill and decode;
the vocabulary is split over ``model`` (a masked embedding on the rank's
rows and one all_reduce; local logits; ``loss_fn``'s vocabulary-parallel
cross-entropy; ``forward``, ``prefill`` and ``decode_step`` all-gather
their logits); a decode step attends a K/V cache whose sequence is split
where it lies, updates a split ``mamba2``/``mlstm`` state in the layout its
cache has, and gathers an ``slstm`` state (or the state of a block whose
heads the line does not divide) whole at its use, writing its block of the
new state back.  Kernels 6-8 run unchanged on local activations: kernel 8
on a rank's heads.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fed.tasks import tree_leaves
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models import sharding as msh
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
STATE_KINDS = ("mamba2", "mlstm", "slstm")  # a recurrent state, O(1) in the sequence
HEADS_KINDS = ("mamba2", "mlstm")  # computed on a rank's heads under the ``state`` rule
# The dimensions (of one repeat's leaf: 0 the batch) a split-heads block's
# state may be split on over the model line (None: whole).
_CELL_DIMS = {"mamba2": {"conv": (2,), "ssm": (None, 1, 2, 3)},
              "mlstm": {"conv": (2,), "c": (None, 1, 2, 3), "n": (None, 1, 2), "m": (None, 1)}}
_STATE_INIT = {"mlstm": xlstm_mod.init_mlstm_state, "slstm": xlstm_mod.init_slstm_state}


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


def _decode_attn(p, cfg: ArchConfig, x, cache, index, rope, masks: dict, *, window=None,
                 kv=None):
    """The paged cache (the serving engine's pool + page table) routes to
    ``paged_decode_attention``, the dense layout to ``decode_attention``.
    ``masks`` memoizes the step's decode mask per window across layers.
    ``kv``: the mesh line a dense cache's sequence is split over
    (``attention.split_decode_attention``)."""
    if kv is not None:
        return attn_mod.split_decode_attention(p, cfg, x, cache, index, kv, window=window,
                                               rope=rope)
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
                 index=None, max_seq=None, masks=None, shared=None, cross_src=None, kv=None,
                 line=None, layout=None):
    """Returns (h, new_cache, aux): aux the block's MoE load-balance loss
    (None for the other kinds).  ``rope``: the (cos, sin) tables of the
    positions this call processes, shared by every layer.  ``shared_attn``
    runs the ``attn`` block ``shared`` with this invocation's cache; a
    recurrent decode (``mamba2``, ``mlstm``, ``slstm``) updates its cache
    in place.  ``cross_src``: the cross-attention source (B, S_src, d) of
    ``cross_attn`` and ``dec`` in train and prefill; decode reads the
    cross cache.  ``kv``: the split self-attention cache's line (decode
    under a mesh).  ``line``: the ``model`` line a ``mamba2``/``mlstm``
    block computes its heads over, ``layout`` its cache's layout (prefill
    and decode), both from ``_split_cells``."""
    if kind == "shared_attn":
        return _apply_block("attn", shared, cfg, h, rope, mode=mode, cache=cache, index=index,
                            max_seq=max_seq, masks=masks, kv=kv)
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
            y, self_cache = _decode_attn(p["attn"], cfg, x, cache["self"], index, rope, masks,
                                         kv=kv)
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
            y, cache = ssm_mod.mamba2_decode_step(p["ssm"], cfg, x, cache, line, layout)
        elif mode == "prefill":
            y, cache = ssm_mod.mamba2_block(p["ssm"], cfg, x, return_state=True, line=line,
                                            layout=layout)
        else:
            y = ssm_mod.mamba2_block(p["ssm"], cfg, x, line=line)
        return h + y, cache, None
    if kind == "mlstm":
        if mode == "decode":
            y, cache = xlstm_mod.mlstm_decode_step(p["cell"], cfg, x, cache, line, layout)
        elif mode == "prefill":
            y, cache = xlstm_mod.mlstm_prefill(p["cell"], cfg, x, line, layout)
        else:
            y = xlstm_mod.mlstm_block(p["cell"], cfg, x, line)
        return h + y, cache, None
    if kind == "slstm":
        if mode == "decode":
            y, cache = xlstm_mod.slstm_decode_step(p["cell"], cfg, x, cache)
        elif mode == "prefill":
            state0 = xlstm_mod.init_slstm_state(cfg, x.shape[0], device=x.device)
            y, cache = _recurrent_prefill(
                lambda tok, st: xlstm_mod.slstm_decode_step(p["cell"], cfg, tok, st), state0, x)
        else:
            y = xlstm_mod.slstm_block(p["cell"], cfg, x)
        return h + y, cache, None
    window = cfg.sliding_window if kind == "attn_local" else None
    if mode == "decode":
        y, cache = _decode_attn(p["attn"], cfg, x, cache, index, rope, masks, window=window,
                                kv=kv)
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
               cross_src=None, cache_specs=None):
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
    (kernels 6-8 launch again there) and keeps only its input.

    Under a mesh (``models.sharding.active``) ``params`` are this rank's
    blocks: each group gathers its blocks' leaves (and ``shared``'s) at its
    entry (``sharding.use_block``), inside the recomputed group under
    remat, but the leaves the blocks consume split: the MLP's and the
    experts', and a ``mamba2``/``mlstm`` block's projections where the
    ``model`` line divides its heads (``_split_cells``).  ``cache_specs``
    (``launch.sharding.cache_shardings``; prefill and decode) give each
    slot's cache layout: a self-attention cache's split sequence is
    attended where it lies, a cross cache is gathered whole; a split-heads
    block's state is updated (decode) or laid out (prefill) where its cache
    holds it; any other recurrent state (``slstm``, a block whose heads
    the line does not divide or whose cache the split cell cannot take) is
    gathered whole, the unsplit cell updates it, and this rank's block of
    the new state is written back into the cache in place
    (``_keep_blocks``)."""
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
    specs = _specs(cfg)
    block_specs = None if specs is None else [msh.drop_lead(s) for s in specs["stacks"]]
    lines, cells = _split_cells(cfg, block_specs, cache_specs)
    kvs = [None] * len(cfg.block_pattern)
    if specs is not None and mode == "decode":
        kvs = [None if line is not None else _decode_layout(kind, s)
               for kind, s, line in zip(cfg.block_pattern, cache_specs, lines)]
    rules = msh.captured()

    def group(h, blocks, shared, cross_src, rope, r=None):
        if rules is None:
            return _group(h, blocks, shared, cross_src, rope, r)
        with msh.entered(rules):  # a recomputed group may run on another thread
            return _group(h, blocks, shared, cross_src, rope, r)

    def _group(h, blocks, shared, cross_src, rope, r=None):
        if block_specs is not None:
            blocks = [msh.use_block(b, s, kind=kind if line is not None else None)
                      for b, s, kind, line in zip(blocks, block_specs, cfg.block_pattern, lines)]
            if shared is not None:
                shared = msh.use_block(shared, specs["shared"])
        aux_sum = None
        for j, kind in enumerate(cfg.block_pattern):
            cache = None if r is None or caches is None else _rep(caches[j], r)
            layout = kv = kvs[j]
            held = None  # this rank's blocks of a gathered recurrent state
            if layout is not None and kind in ("cross_attn", "dec"):
                cache, kv = _gather_cross(kind, cache, layout), layout["self"]
            elif layout is not None and kind in STATE_KINDS:
                held, cache, kv = cache, _gathered(cache, layout), None
            h, nc, aux = _apply_block(
                kind, blocks[j], cfg, h, rope, mode=mode, cache=cache,
                index=index, max_seq=max_seq, masks=masks, shared=shared,
                cross_src=cross_src, kv=kv, line=lines[j], layout=cells[j],
            )
            if held is not None:
                nc = _keep_blocks(held, nc, layout)
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
        caches = [_stack(c) for c in out_caches]
        if cache_specs is not None:
            caches = _cut_caches(caches, cache_specs, lines)
        return h, aux, caches
    return h, aux, caches


def _specs(cfg: ArchConfig):
    """The whole tree's parameter specs under an active mesh, else None."""
    ctx = msh.active()
    if ctx is None:
        return None
    from repro_torch.launch.sharding import whole_param_specs

    return whole_param_specs(cfg, ctx[0], ctx[2])


def _split_cells(cfg: ArchConfig, block_specs, cache_specs=None) -> tuple:
    """(lines, cells): per pattern slot, the ``model`` line a ``mamba2``/
    ``mlstm`` block computes its heads over, and the layout its split cell
    takes the cache in (``_cell_layout``; None without ``cache_specs``).
    A slot has a line when the rules' ``state`` axis is ``model``, the line
    divides the block's heads, ``param_specs`` splits every leaf the block
    consumes and, given ``cache_specs`` (prefill and decode), the cell can
    take the cache's layout.  Otherwise its leaves (and state) are gathered
    whole at use: no mesh; ``slstm`` and the other kinds; a line of more
    ranks than divide the heads (xlstm-125m's 4 heads on a line of 16); a
    conv state left whole because a dimension equals ``max_seq``."""
    from repro_torch.launch.sharding import spec_axes

    lines, cells = [None] * len(cfg.block_pattern), [None] * len(cfg.block_pattern)
    line = msh.group_of("model") if msh.axes_of("state") == ("model",) else None
    if block_specs is None or line is None:
        return lines, cells
    for j, kind in enumerate(cfg.block_pattern):
        if kind not in HEADS_KINDS:
            continue
        heads = (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim if kind == "mamba2"
                 else cfg.n_heads)
        parent = "ssm" if kind == "mamba2" else "cell"
        spec = block_specs[j][parent]
        if heads % line.size or not all(any(spec_axes(e) == ("model",) for e in spec[leaf])
                                        for leaf in msh.CONSUMED[(kind, parent)]):
            continue
        if cache_specs is not None:
            cells[j] = _cell_layout(kind, _held(msh.drop_lead(cache_specs[j])), line)
            if cells[j] is None:
                continue
        lines[j] = line
    return lines, cells


def _vocab_group(entry):
    """The ``model`` line a vocabulary dimension (its spec entry) is split
    over, or None."""
    from repro_torch.launch.sharding import spec_axes

    return msh.group_of("model") if "model" in spec_axes(entry) else None


def _embed(params, cfg: ArchConfig, tokens):
    """The embedding; under a vocabulary split over ``model`` each rank
    looks up the tokens its rows hold (zeros for the others) and one
    all_reduce sums them, exact (one nonzero term)."""
    emb, group = params["embed"], None
    specs = _specs(cfg)
    if specs is not None:
        emb = msh.use_leaf(emb, specs["embed"], consumed=True)
        group = _vocab_group(specs["embed"][0])
    # F.embedding, not params["embed"][tokens]: under vmap(grad) the
    # indexing backward sums repeated tokens in a thread-dependent order, so
    # two federated runs of one spec would differ in the last bits.
    if group is None:
        h = torch.nn.functional.embedding(tokens, emb)
    else:
        rows = emb.shape[0]
        ids = tokens - group.rank * rows
        inside = (ids >= 0) & (ids < rows)
        h = torch.nn.functional.embedding(torch.where(inside, ids, 0), emb)
        h = msh.all_reduce(h * inside[..., None].to(h.dtype), group)
    if cfg.scale_embed:
        # sqrt(d_model) rounded to h's dtype first, as the reference does; a
        # host scalar, so no host-to-device copy.
        h = h * float(torch.tensor(cfg.d_model**0.5, dtype=h.dtype))
    return h


def _encode(params, cfg: ArchConfig, frames):
    """Whisper's encoder over the stubbed post-convolution features frames
    (B, S_frames, frontend_dim): the frontend projection, learned
    positions, the ``enc`` blocks, the encoder's final norm."""
    specs = _specs(cfg)
    enc, proj = params["encoder"], params["frontend_proj"]
    if specs is not None:
        enc = msh.use_block(enc, specs["encoder"])
        proj = msh.use_leaf(proj, specs["frontend_proj"])
    h = frames.to(cfg.param_dtype) @ proj + enc["pos"][None]
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
    proj = params["frontend_proj"]
    specs = _specs(cfg)
    if specs is not None:
        proj = msh.use_leaf(proj, specs["frontend_proj"])
    return aux_embeds.to(cfg.param_dtype) @ proj


def _final_norm(params, cfg: ArchConfig, h):
    scale = params["final_norm"]
    specs = _specs(cfg)
    if specs is not None:
        scale = msh.use_leaf(scale, specs["final_norm"])
    return rms_norm(h, scale, cfg.norm_eps)


def _local_head(params, cfg: ArchConfig, h):
    """(logits over this rank's vocabulary columns, the ``model`` line they
    are split over or None).  A tied head uses ``embed.T``'s block."""
    name = "lm_head" if "lm_head" in params else "embed"
    head, group = params[name], None
    specs = _specs(cfg)
    if specs is not None:
        head = msh.use_leaf(head, specs[name], consumed=True)
        group = _vocab_group(specs[name][1 if name == "lm_head" else 0])
    if name == "embed":
        head = head.T
    # h is whole on every rank, its gradient through each block partial.
    logits = softcap(msh.reduce_grad(h, group) @ head, cfg.final_softcap)
    return msh.shard(logits, "batch", "seq", "vocab", whole=(None, None, cfg.vocab)), group


def _whole_logits(params, cfg: ArchConfig, h):
    """The logits (B, S, V): under a split vocabulary all-gathered, since
    sampling needs whole rows."""
    logits, group = _local_head(params, cfg, h)
    return msh.all_gather(logits, group, -1)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, aux_embeds=None):
    """Training forward: tokens (B, S) [+ aux_embeds (B, S_front, F)] ->
    (logits (B,S,V), aux_loss)."""
    h, aux = _trunk(params, cfg, tokens, aux_embeds)
    return _whole_logits(params, cfg, h), aux


def _trunk(params, cfg: ArchConfig, tokens, aux_embeds):
    """The final-normed residual stream (B, S, d) and the MoE aux loss."""
    h = _embed(params, cfg, tokens)
    cross_src = _cross_source(params, cfg, aux_embeds)
    h, aux, _ = _run_stack(params, cfg, h, mode="train", cross_src=cross_src)
    h = msh.shard(h, "batch", "seq", None)
    h = _final_norm(params, cfg, h)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """batch: (tokens, targets) or (tokens, targets, aux_embeds).  Mean
    next-token cross-entropy in f32 plus
    ``MOE_AUX_COEF`` times the MoE load-balance loss (zero without ``moe``
    blocks).  Under a mesh: the vocabulary-parallel cross-entropy (the max,
    the sum of exponentials and the gold logit all_reduced over the
    vocabulary's line, f32), averaged over the batch axes when this rank
    holds a block of the rows."""
    tokens, targets = batch[0], batch[1]
    h, aux = _trunk(params, cfg, tokens, batch[2] if len(batch) > 2 else None)
    logits, group = _local_head(params, cfg, h)
    logits = logits.to(torch.float32)
    if group is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    else:
        m = msh.all_reduce(logits.detach().amax(-1), group, "max")
        sumexp = msh.all_reduce(torch.exp(logits - m[..., None]).sum(-1), group)
        logz = torch.log(sumexp) + m
        cols = logits.shape[-1]
        t = targets.long() - group.rank * cols
        inside = (t >= 0) & (t < cols)
        gold = torch.gather(logits, -1, torch.where(inside, t, 0)[..., None])[..., 0]
        gold = msh.all_reduce(torch.where(inside, gold, 0.0), group)
    loss = torch.mean(logz - gold) + MOE_AUX_COEF * aux
    rows = msh.batch_group()
    if rows is not None:
        loss = msh.all_reduce(loss, rows) / rows.size
    return loss


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
        elif kind in _STATE_INIT:
            c = _STATE_INIT[kind](cfg, batch, device=dev)
        else:
            c = kv_cache()
        return _stack([c] * reps)

    return [one(kind) for kind in cfg.block_pattern]


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, aux_embeds=None, max_seq=None,
            page_size: int | None = None, *, batch: int | None = None):
    """Process the prompt [and the frontend embeddings], return (logits (B,
    1, V), caches).  Self-attention caches are padded to ``max_seq``
    (default: the prompt length); with ``page_size`` they are repacked into
    the paged decode layout.  Under a mesh the caches are this rank's
    blocks (``launch.sharding.cache_shardings`` of the whole ``batch``
    sequences, default ``tokens``' rows: this rank's rows are its block of
    the batch axes where the rules split them)."""
    h = _embed(params, cfg, tokens)
    cross_src = _cross_source(params, cfg, aux_embeds)
    specs = None
    if _specs(cfg) is not None:
        if page_size is not None:
            raise NotImplementedError(f"a paged cache under a mesh: {MODEL_AXIS_LEFT}")
        specs = _whole_cache_specs(cfg, batch or tokens.shape[0], max_seq or tokens.shape[1])
    h, _, caches = _run_stack(params, cfg, h, mode="prefill", max_seq=max_seq, cross_src=cross_src,
                              cache_specs=specs)
    logits = _whole_logits(params, cfg, _final_norm(params, cfg, h)[:, -1:])
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


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches, index: int, *,
                max_seq: int | None = None, batch: int | None = None):
    """token (B, 1) int; index = number of tokens already in the cache (a
    host integer).  Updates ``caches`` in place and returns them.  Under a
    mesh the caches are this rank's blocks of ``cache_shardings`` at
    ``max_seq`` (default: the local caches' length, i.e. not split) and
    ``batch`` sequences (default ``token``'s rows), and stay so: a K/V
    cache is attended and written where its sequence lies, a split-heads
    block's state is updated where it lies, another recurrent state is
    all-gathered at its use and this rank's block of the new state copied
    back (``_run_stack``)."""
    h = _embed(params, cfg, token)
    specs = None
    if _specs(cfg) is not None:
        specs = _whole_cache_specs(cfg, batch or token.shape[0],
                                   max_seq or _cache_len(cfg, caches))
    h, _, caches = _run_stack(params, cfg, h, mode="decode", caches=caches, index=int(index),
                              cache_specs=specs)
    return _whole_logits(params, cfg, _final_norm(params, cfg, h)), caches


# ---------------------------------------------------------------------------
# decode caches under a mesh
# ---------------------------------------------------------------------------

MODEL_AXIS_LEFT = "see ROADMAP.md section 1, 'What is left of the model axis'"


def _cache_len(cfg: ArchConfig, caches) -> int:
    for kind, cache in zip(cfg.block_pattern, caches):
        kv = cache["self"] if kind == "dec" else cache
        if kind in ATTN_KINDS + ("dec",):
            if "k" not in kv:
                raise NotImplementedError(f"a paged cache under a mesh: {MODEL_AXIS_LEFT}")
            return kv["k"].shape[2]
    return 0


def _whole_cache_specs(cfg: ArchConfig, batch: int, max_seq: int):
    """``cache_shardings`` of the whole caches of ``batch`` sequences of
    ``max_seq`` (shapes only, outside any dispatch mode)."""
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.launch.sharding import cache_shardings

    mesh = msh.current_mesh()
    with _disable_current_modes():
        whole = init_caches(cfg, batch, max_seq, device="meta")
        return cache_shardings(whole, mesh, max_seq, batch)


def _kv_line(spec):
    """The mesh line of a K/V cache whose spec (one repeat: (B, S, KV, hd))
    splits the sequence, or None when it is whole.  Other split dimensions
    raise."""
    from repro_torch.launch.sharding import spec_axes

    if any(spec_axes(e) for e in spec[2:]):
        raise NotImplementedError(f"a K/V cache split off its sequence {spec}: {MODEL_AXIS_LEFT}")
    return msh.group_of(spec_axes(spec[1]))


def _held_dims(spec) -> list:
    """``(dim, line)`` of each dimension of one repeat's cache spec that
    this rank holds a block of: every dimension split over a line of more
    than one rank, but the batch's (0) over the batch axes, whose rows are
    this rank's already (as ``_cut_caches`` leaves them)."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.sharding import spec_axes

    b_axes = batch_axes(msh.current_mesh())
    out = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        group = None if dim == 0 and axes == b_axes else msh.group_of(axes)
        if group is not None:
            out.append((dim, group))
    return out


def _decode_layout(kind: str, spec):
    """A slot's decode layout from its stacked cache spec: the self K/V's
    line (``_kv_line``) for the attention kinds, ``{"cross": held, "self":
    line}`` for the cross kinds, and for a recurrent state gathered at use
    each leaf's ``_held_dims`` (None where no leaf is split: the cell
    updates the cache as it is)."""
    one = msh.drop_lead(spec)
    if kind in ATTN_KINDS:
        return _kv_line(one["k"])
    if kind == "cross_attn":
        return {"cross": _held(one), "self": None}
    if kind == "dec":
        return {"cross": _held(one["cross"]), "self": _kv_line(one["self"]["k"])}
    held = _held(one)
    return held if any(held.values()) else None


def _held(specs: dict) -> dict:
    return {k: _held_dims(s) for k, s in specs.items()}


def _cell_layout(kind: str, held: dict, line):
    """The dimension of each state leaf that ``held`` (``_held_dims``)
    splits over ``line``'s ranks (None: whole), as a split-heads cell takes
    it (``_CELL_DIMS``), or None when it cannot."""
    mesh = msh.current_mesh()
    out = {}
    for leaf, dims in held.items():
        if len(dims) > 1 or (dims and mesh.line(dims[0][1].axes) != mesh.line(line.axes)):
            return None
        out[leaf] = dims[0][0] if dims else None
        if out[leaf] not in _CELL_DIMS[kind][leaf]:
            return None
    return out


def _gathered(cache: dict, held: dict) -> dict:
    """Each leaf of a cache all-gathered whole over the lines ``held``
    names (``_held_dims``); a leaf no line splits is the cache's own."""
    out = {}
    for k, leaf in cache.items():
        for dim, group in held[k]:
            leaf = msh.all_gather(leaf, group, dim)
        out[k] = leaf
    return out


def _keep_blocks(cache: dict, whole: dict, held: dict) -> dict:
    """Copy this rank's block of each leaf of the updated ``whole`` state
    into ``cache`` in place; returns ``cache``."""
    for k, leaf in cache.items():
        new = whole[k]
        for dim, group in held[k]:
            m = leaf.shape[dim]
            new = new.narrow(dim, group.rank * m, m)
        if new is not leaf:
            leaf.copy_(new)
    return cache


def _gather_cross(kind: str, cache, layout):
    """A cross cache gathered whole at its use (read only)."""
    cross = cache if kind == "cross_attn" else cache["cross"]
    got = _gathered(cross, layout["cross"])
    return got if kind == "cross_attn" else {"self": cache["self"], "cross": got}


def _cut_caches(caches, specs, lines):
    """A prefill's caches (this rank's rows, every position) cut to this
    rank's blocks of ``specs`` (``cache_shardings``): every split dimension
    but the batch, whose rows are already this rank's.  A slot with a
    ``line`` (``_split_cells``) comes laid out already."""
    from repro_torch.launch.sharding import block_of, spec_axes
    from repro_torch.launch.mesh import batch_axes

    mesh = msh.current_mesh()
    b_axes = batch_axes(mesh)

    def cut(leaf, spec):
        spec = tuple(None if spec_axes(e) == b_axes and i == 1 else e for i, e in enumerate(spec))
        return block_of(leaf, spec, mesh)

    def walk(c, s):
        if isinstance(c, dict):
            return {k: walk(c[k], s[k]) for k in c}
        return cut(c, s)

    return [c if line is not None else walk(c, s) for c, s, line in zip(caches, specs, lines)]
