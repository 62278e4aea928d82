"""Trainable tasks for the paper-scale federated experiments.

Each task bundles parameter init, a per-batch loss and an accuracy metric.
The models are ``nn.Module``s whose parameters carry the JAX reference's
names and its (in, out) weight layout (``repro/fed/tasks.py``).  Training is
functional: a task's parameters are a nested dict of tensors, shaped like the
reference's pytree, and the module runs on them through
``torch.func.functional_call``, so ``torch.func.grad`` and ``vmap`` apply
directly.  The modules themselves live on the ``meta`` device and hold no
storage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Task",
    "logistic_regression",
    "mlp_classifier",
    "tiny_lm",
    "params_from_reference",
    "params_to_numpy",
    "tree_map",
    "tree_leaves",
]


def tree_leaves(tree) -> list:
    """Leaves of nested dicts and lists in the reference's pytree order:
    dict keys sorted at every level, lists in order
    (``jax.tree_util.tree_flatten``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples of identical
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def _dotted(tree, prefix: str = "") -> dict:
    """Nested dict -> ``{"blk0.qkv": tensor, ...}`` as ``functional_call``
    names module parameters."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_dotted(v, name + "."))
        else:
            out[name] = v
    return out


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    init: Callable  # (torch.Generator, device) -> params
    loss: Callable  # (params, (x, y)) -> scalar
    accuracy: Callable  # (params, (x, y)) -> scalar


def _xent(logits, y):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, y.long()[..., None], dim=-1)[..., 0]
    return (logz - gold).mean()


def _task(name: str, module: nn.Module, init: Callable) -> Task:
    def forward(params, x):
        return torch.func.functional_call(module, _dotted(params), (x,))

    def loss(params, batch):
        x, y = batch
        return _xent(forward(params, x), y)

    def accuracy(params, batch):
        x, y = batch
        return (forward(params, x).argmax(-1) == y).to(torch.float32).mean()

    return Task(name, init, loss, accuracy)


def _meta(module_cls, *args) -> nn.Module:
    with torch.device("meta"):
        return module_cls(*args)


class _Linear(nn.Module):
    """x @ w + b with w stored (in, out), as the reference keeps it."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out))

    def forward(self, x):
        return x @ self.w + self.b


def logistic_regression(dim: int = 60, n_classes: int = 10) -> Task:
    """The paper's Section 6.1 model: f(x) = argmax(Wx + b)."""

    def init(gen: torch.Generator, device):
        return {
            "w": torch.randn(dim, n_classes, generator=gen, device=device) * 0.01,
            "b": torch.zeros(n_classes, device=device),
        }

    return _task("logreg", _meta(_Linear, dim, n_classes), init)


class _MLP(nn.Module):
    def __init__(self, sizes: list):
        super().__init__()
        for i in range(len(sizes) - 1):
            self.add_module(f"l{i}", _Linear(sizes[i], sizes[i + 1]))

    def forward(self, x):
        layers = list(self.children())
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = F.relu(x)
        return x


def mlp_classifier(dim: int, n_classes: int, hidden: int = 128, depth: int = 2) -> Task:
    """Stand-in for the paper's FEMNIST CNN at simulation scale."""
    sizes = [dim] + [hidden] * depth + [n_classes]

    def init(gen: torch.Generator, device):
        return {
            f"l{i}": {
                "w": torch.randn(sizes[i], sizes[i + 1], generator=gen, device=device)
                * math.sqrt(2.0 / sizes[i]),
                "b": torch.zeros(sizes[i + 1], device=device),
            }
            for i in range(depth + 1)
        }

    return _task("mlp", _meta(_MLP, sizes), init)


def _rms(h):
    return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6)


class _Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = nn.Parameter(torch.empty(d_model, 3 * d_model))
        self.proj = nn.Parameter(torch.empty(d_model, d_model))
        self.up = nn.Parameter(torch.empty(d_model, 4 * d_model))
        self.down = nn.Parameter(torch.empty(4 * d_model, d_model))

    def forward(self, h, mask):
        b, s, d = h.shape
        hd = d // self.n_heads
        q, k, v = (_rms(h) @ self.qkv).split(d, dim=-1)
        q, k, v = (t.reshape(b, s, self.n_heads, hd) for t in (q, k, v))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = torch.where(mask, att, -1e9).softmax(dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, d)
        h = h + o @ self.proj
        # jax.nn.gelu defaults to the tanh approximation.
        return h + F.gelu(_rms(h) @ self.up, approximate="tanh") @ self.down


class _TinyLM(nn.Module):
    def __init__(self, vocab: int, d_model: int, n_layers: int, n_heads: int):
        super().__init__()
        self.emb = nn.Parameter(torch.empty(vocab, d_model))
        for i in range(n_layers):
            self.add_module(f"blk{i}", _Block(d_model, n_heads))

    def forward(self, tokens):
        s = tokens.shape[1]
        # F.embedding, not self.emb[tokens]: the indexing backward
        # accumulates repeated tokens in a thread-dependent order on the CPU,
        # so two runs of one spec would differ in the last bits.
        h = F.embedding(tokens.long(), self.emb)
        mask = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
        for blk in self.children():
            h = blk(h, mask)
        return _rms(h) @ self.emb.T


def tiny_lm(vocab: int = 256, d_model: int = 64, n_layers: int = 2, n_heads: int = 4) -> Task:
    """Miniature decoder LM for the Section 6.3-style federated text task:
    pre-RMSNorm causal attention + tanh-GELU MLP, tied embeddings."""

    def init(gen: torch.Generator, device):
        def normal(*shape):
            return torch.randn(*shape, generator=gen, device=device) * 0.02

        params = {"emb": normal(vocab, d_model)}
        for i in range(n_layers):
            params[f"blk{i}"] = {
                "qkv": normal(d_model, 3 * d_model),
                "proj": normal(d_model, d_model),
                "up": normal(d_model, 4 * d_model),
                "down": normal(4 * d_model, d_model),
            }
        return params

    return _task("tiny_lm", _meta(_TinyLM, vocab, d_model, n_layers, n_heads), init)


def params_from_reference(np_params, device="cpu"):
    """The JAX reference's parameter pytree, as nested dicts of numpy
    arrays, -> the port's parameters: same names, same (in, out) layout."""
    dev = torch.device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), np_params)


def params_to_numpy(params):
    """The port's parameters -> nested dicts of numpy arrays (host copies).
    numpy holds no bfloat16: such leaves widen to float32, exactly."""

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(host, params)
