"""Parameter, cache and activation layouts for a (data, model) mesh (the
port of ``repro/launch/sharding.py``, the reference's rules and leaf names).

A spec is a tuple with one entry a dimension, the entries of a
``PartitionSpec``: None (whole), an axis name, or a tuple of names (the
dimension's blocks laid row-major over them).  Parameter specs go by leaf
*name* (the nearest dict key above the leaf): expanding projections split
their output features over ``model``, contracting projections their input
features; the MoE expert stacks split the expert axis, ``embed`` and
``lm_head`` the vocabulary; ``fsdp`` also scatters the d_model-ish axis over
the batch axes (``("data",)``, or ``("pod", "data")``).  A dimension the
axes do not divide evenly (or that is smaller than them) stays whole.

Cache specs go by shape: the sequence axis (== max_seq) splits over the
kv_seq axes, the batch axis over the batch axes, otherwise the largest
mesh-divisible trailing dimension goes to ``model``.

``param_shardings`` cuts this rank's block of each leaf (contiguous, a
storage of its own); ``gather_params`` is its inverse over a
``torch.distributed`` group, and ``assemble`` puts the blocks of every rank
back together where they are all at hand (a test's or a checkpoint's).
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import batch_axes, fsdp_axes

__all__ = [
    "param_specs",
    "param_shardings",
    "cache_shardings",
    "activation_rules",
    "block_of",
    "gather_params",
    "assemble",
    "whole_param_specs",
    "spec_axes",
]

# leaf-name -> role
_EXPAND = {"wq", "wk", "wv", "up", "gate", "in_proj", "w_in", "ffn_up", "ffn_gate", "w_if", "qkv"}
_CONTRACT = {"wo", "down", "out_proj", "ffn_down"}
_MOE_IN = {"w_gate", "w_up"}  # (L, E, d, f)
_MOE_OUT = {"w_down"}  # (L, E, f, d)


def _divides(n: int, axes: tuple, mesh) -> bool:
    size = math.prod(mesh.shape[a] for a in axes) if axes else 1
    return n % size == 0 and n >= size


def _spec_for(name: str, shape: tuple, mesh, fsdp: bool) -> tuple:
    model = "model"
    fs = fsdp_axes(mesh) if fsdp else None
    nd = len(shape)

    def pad(trailing: tuple) -> tuple:
        return (None,) * (nd - len(trailing)) + trailing

    if name == "embed" and nd == 2:
        vocab_ok = _divides(shape[0], ("model",), mesh)
        d_ok = fs is not None and _divides(shape[1], fs, mesh)
        return (model if vocab_ok else None, fs if d_ok else None)
    if name == "lm_head" and nd == 2:
        d_ok = fs is not None and _divides(shape[0], fs, mesh)
        vocab_ok = _divides(shape[1], ("model",), mesh)
        return (fs if d_ok else None, model if vocab_ok else None)
    if name in _MOE_IN and nd >= 3:
        e_ok = _divides(shape[-3], ("model",), mesh)
        d_ok = fs is not None and _divides(shape[-2], fs, mesh)
        return pad((model if e_ok else None, fs if d_ok else None, None))
    if name in _MOE_OUT and nd >= 3:
        e_ok = _divides(shape[-3], ("model",), mesh)
        d_ok = fs is not None and _divides(shape[-1], fs, mesh)
        return pad((model if e_ok else None, None, fs if d_ok else None))
    if name == "router" and nd >= 2:
        return pad((None, model if _divides(shape[-1], ("model",), mesh) else None))
    if name in _EXPAND and nd >= 2:
        out_ok = _divides(shape[-1], ("model",), mesh)
        in_ok = fs is not None and _divides(shape[-2], fs, mesh)
        return pad((fs if in_ok else None, model if out_ok else None))
    if name in _CONTRACT and nd >= 2:
        in_ok = _divides(shape[-2], ("model",), mesh)
        out_ok = fs is not None and _divides(shape[-1], fs, mesh)
        return pad((model if in_ok else None, fs if out_ok else None))
    if name == "conv_w" and nd >= 2:
        return pad((model if _divides(shape[-1], ("model",), mesh) else None,))
    # norms, biases, scalars, pos embeddings, small recurrent mats: whole
    return (None,) * nd


def _map_named(fn, tree, name=""):
    """``fn(name, leaf)`` over a nest of dicts and lists, ``name`` the
    nearest dict key above the leaf."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def param_specs(params, mesh, fsdp: bool):
    """A tree of specs mirroring ``params`` (tensors, ``meta`` ones too)."""
    return _map_named(lambda name, leaf: _spec_for(name, tuple(leaf.shape), mesh, fsdp), params)


def spec_axes(entry) -> tuple:
    """A spec entry's mesh axes, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_of(x: torch.Tensor, spec: tuple, mesh, rank: int | None = None) -> torch.Tensor:
    """Rank ``rank``'s (default this process's) block of ``x`` under
    ``spec``: a contiguous copy of its own (a leading block is no view that
    keeps the whole leaf alive), or ``x`` itself where nothing is split."""
    split = False
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            m = x.shape[dim] // mesh.axis_size(axes)
            x = x.narrow(dim, mesh.index(axes, rank) * m, m)
            split = True
    return x.clone(memory_format=torch.contiguous_format) if split else x


def param_shardings(params, mesh, fsdp: bool, rank: int | None = None):
    """This rank's block of each leaf (``params_from_reference`` then this
    gives each rank's block of the reference's weights)."""
    specs = param_specs(params, mesh, fsdp)
    return _zip_map(lambda x, s: block_of(x, s, mesh, rank), params, specs)


def gather_params(blocks, specs, mesh):
    """The whole leaves of a tree of this rank's blocks (every rank calls
    it, over the mesh's groups)."""

    def one(x, spec):
        for dim in reversed(range(len(spec))):
            axes = spec_axes(spec[dim])
            if axes:
                x = mesh.axis_group(axes).all_gather(x, dim)
        return x

    return _zip_map(one, blocks, specs)


def assemble(per_rank: list, specs, mesh):
    """The whole leaves from ``per_rank[r]``, rank r's tree of blocks."""

    def one(spec, *blocks):
        parts = {r: b for r, b in enumerate(blocks)}
        for dim in reversed(range(len(spec))):
            axes = spec_axes(spec[dim])
            if not axes:
                continue
            merged = {}
            for r in parts:
                line = mesh.line(axes, r)
                if r == line[0]:
                    merged[r] = torch.cat([parts[q] for q in line], dim)
            parts = merged
        return parts[0]

    def walk(spec, trees):
        if isinstance(spec, dict):
            return {k: walk(spec[k], [t[k] for t in trees]) for k in spec}
        if isinstance(spec, list):
            return [walk(s, [t[i] for t in trees]) for i, s in enumerate(spec)]
        return one(spec, *trees)

    return walk(specs, per_rank)


_WHOLE_SPECS: dict = {}


def whole_param_specs(cfg, mesh, fsdp: bool):
    """``param_specs`` of ``cfg``'s whole tree (built on ``meta``, outside
    any dispatch mode: a dry run's count sees none of it), memoized."""
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.models import transformer

    key = (repr(cfg), mesh, bool(fsdp))
    if key not in _WHOLE_SPECS:
        if len(_WHOLE_SPECS) >= 64:
            _WHOLE_SPECS.clear()
        with _disable_current_modes():
            _WHOLE_SPECS[key] = param_specs(transformer._init_tree(cfg, None), mesh, fsdp)
    return _WHOLE_SPECS[key]


def cache_shardings(caches, mesh, max_seq: int, batch: int):
    """Decode-cache specs by shape (module docstring); dim 0, the pattern
    repeats' stack, is never split."""
    b_axes = batch_axes(mesh)
    b_size = math.prod(mesh.shape[a] for a in b_axes)
    m_size = mesh.shape["model"]

    def assign(leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        used_model = used_batch = False
        for i, s in enumerate(shape):
            if i == 0:
                continue
            if s == max_seq and not used_model:
                # the long axis: kv_seq -> model (+ batch axes when batch==1)
                if batch == 1 and s % (b_size * m_size) == 0:
                    spec[i] = b_axes + ("model",)
                elif s % m_size == 0:
                    spec[i] = "model"
                used_model = True
            elif s == batch and not used_batch and batch % b_size == 0:
                spec[i] = b_axes
                used_batch = True
        if not used_model:
            cand = [(s, i) for i, s in enumerate(shape)
                    if i > 0 and spec[i] is None and s % m_size == 0]
            if cand:
                _, i = max(cand)
                spec[i] = "model"
        return tuple(spec)

    return _map_named(lambda _, leaf: assign(leaf), caches)


def activation_rules(mesh, *, long_context: bool = False, client_parallel: bool = False) -> dict:
    b_axes = batch_axes(mesh)
    return {
        # client_parallel vmaps the model over the cohort: the client dim
        # carries the batch axes, the inner per-client batch is whole.
        "batch": None if client_parallel else b_axes,
        "clients": b_axes,
        "heads": ("model",),
        "kv_heads": None,  # kv head counts are small (4-16); kept whole
        "ffn": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "embed": None,
        "seq": None,
        "kv_seq": b_axes + ("model",) if long_context else ("model",),
        "state": ("model",),
    }
