"""The count of one step of the port without running it: the operations,
the bytes and the memory of the eager ops the card would run.

The reference counts a step by walking XLA's compiled HLO
(``repro/analysis/hlo.py:analyze_hlo``).  The port runs eagerly and has no
program to walk, so ``count(fn, *args)`` runs ``fn`` once on ``meta``
tensors (shapes, dtypes and strides, no data, no card, CUDA never
initialised: ATen's meta kernels compute each op's output) under a
``TorchDispatchMode`` that sees every ATen op as it is dispatched, after
``vmap`` has batched it and autograd has recorded it: the forward, the
backward (``grad``, ``backward``, ``models/remat.recompute``'s recompute)
and the in-place updates, op by op.  For each op:

* ``flops``: the matmul class (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, attention: ``torch.utils.flop_counter``'s registry, 2 a
  multiply-add) by its formula; a pointwise op (``torch.Tag.pointwise``)
  one an output element; a reduction (``torch.Tag.reduction``, and softmax,
  log-softmax and cumulative sums) one an input element; other ops
  (copies, gathers, indexing, factories) none;
* ``bytes_accessed``: the bytes of its tensor inputs read (the elements
  each can address: a broadcast input once) and of its outputs written.
  Views and metadata ops move nothing (and ops that return no tensor are
  not counted at all).  This is eager execution's traffic, with no fusion:
  every intermediate goes through HBM;
* memory: every storage an op returns is live from then until its last
  tensor dies (storages by identity, so views and in-place ops add
  nothing); ``temp_size_bytes`` is the peak of the live storages during
  the call less the arguments', as the card's allocator would see it
  without its rounding or cached blocks.

Kernels 6-8 are counted as their kernels, not as their plain versions: on
``meta`` tensors each wrapper allocates the kernel's outputs and charges
the kernel's work (``kernels/_common.meta_call``: the operations
and the bytes read once and written once of ``rmsnorm.work``,
``flash_attention.work``, ``ssd_scan.work``) to the innermost count.  Their
PyTorch backwards run op by op, as on the card: kernel 7's (S_q, S_k) f32
transient is counted because the card allocates it too.

``counting()`` counts whatever runs inside it on ``meta`` tensors the
caller makes.  One card has no collectives: ``collective_bytes`` is 0.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["Cost", "count", "counting"]

# Ops that move no data: views by schema, and these.
_NO_TRAFFIC = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_unsafe_view",
    "detach", "alias", "lift_fresh", "resize_", "set_",
}
# Ops without the reduction tag that reduce along a dimension.
_REDUCTION_LIKE = {
    "_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "cumsum", "cumprod", "logcumsumexp",
}
_POINTWISE, _REDUCTION = torch.Tag.pointwise, getattr(torch.Tag, "reduction", None)
# Kernels whose charged operations are products (kernel 6's are pointwise).
_MATMUL_KERNELS = ("flash_attention", "ssd_scan")


@dataclasses.dataclass
class Cost:
    """The count of one call (``count``)."""

    flops: float = 0.0
    matmul_flops: float = 0.0  # the registry's ops, and kernels 7 and 8
    pointwise_flops: float = 0.0  # one an output element, and kernel 6
    reduction_flops: float = 0.0  # one an input element
    bytes_accessed: float = 0.0
    argument_size_bytes: int = 0
    output_size_bytes: int = 0
    temp_size_bytes: int = 0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)  # ATen op name -> calls
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> calls, flops, bytes

    @property
    def memory(self) -> dict:
        """The reference's ``memory`` record (``compiled.memory_analysis()``)."""
        return {
            "argument_size_bytes": self.argument_size_bytes,
            "output_size_bytes": self.output_size_bytes,
            "temp_size_bytes": self.temp_size_bytes,
            "generated_code_size_bytes": 0,
        }


def _tensors(tree):
    """The tensor leaves of a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _is_view(func) -> bool:
    """Whether an op returns a view of an input (an alias it does not
    write), by its schema."""
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` can address: a broadcast (stride 0)
    axis once."""
    return math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0) * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts every op dispatched under it into a ``Cost``, and tracks the
    live storages."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.ops = collections.Counter()
        self._live: dict = {}  # id(storage) -> nbytes
        self._now = 0
        self.peak = 0

    def track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live:
            return
        nbytes = storage.nbytes()
        self._live[key] = nbytes
        self._now += nbytes
        self.peak = max(self.peak, self._now)
        weakref.finalize(storage, self._free, key)

    def _free(self, key) -> None:
        self._now -= self._live.pop(key, 0)

    def charge(self, name: str, flops: int, n_bytes: int) -> None:
        """A kernel's work (``kernels/_common.meta_call``)."""
        c = self.cost
        c.flops += flops
        if name in _MATMUL_KERNELS:
            c.matmul_flops += flops
        else:
            c.pointwise_flops += flops
        c.bytes_accessed += n_bytes
        k = c.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if not outs:  # a query of metadata (``prim.device``, sizes)
            return out
        for t in outs:
            self.track(t)
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        if name in _NO_TRAFFIC or _is_view(func):
            return out
        ins = list(_tensors((args, kwargs)))
        c = self.cost
        c.bytes_accessed += sum(_read_bytes(t) for t in ins) + sum(
            t.numel() * t.element_size() for t in outs)
        if func.overloadpacket in flop_registry:
            f = flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
            c.matmul_flops += f
        elif _POINTWISE in func.tags:
            f = sum(t.numel() for t in outs)
            c.pointwise_flops += f
        elif name in _REDUCTION_LIKE or (_REDUCTION is not None and _REDUCTION in func.tags):
            f = ins[0].numel() if ins else 0
            c.reduction_flops += f
        else:
            f = 0
        c.flops += f
        return out


@contextlib.contextmanager
def counting(cost: Cost, arguments=()):
    """Count every op dispatched inside the block into ``cost`` (the
    innermost count when nested), the storages of the tensors in
    ``arguments`` taken as live from the start; on leaving, the peak of
    the live storages less the arguments' is ``cost.temp_size_bytes``."""
    from repro_torch.kernels import _common

    counter = _Counter(cost)
    for t in _tensors(arguments):
        counter.track(t)
    cost.argument_size_bytes = counter.peak = counter._now
    _common.COUNTS.append(counter)
    try:
        with counter:
            yield cost
    finally:
        _common.COUNTS.pop()
        cost.temp_size_bytes = counter.peak - cost.argument_size_bytes
        cost.ops = dict(counter.ops.most_common())


def count(fn, *args, **kwargs) -> tuple[Cost, object]:
    """Run ``fn(*args, **kwargs)`` once on ``meta`` tensors of the tensors in
    ``args`` and ``kwargs`` (their shapes, strides and dtypes; ``meta`` or
    real ones, each a storage of its own; other leaves pass as they are)
    and count it.  Returns ``(cost, out)``, ``out`` on ``meta``."""
    meta = lambda t: torch.empty_strided(  # noqa: E731
        t.shape, t.stride(), dtype=t.dtype, device="meta").requires_grad_(t.requires_grad)
    args, kwargs = _map_tensors(meta, (args, kwargs))
    cost = Cost()
    with counting(cost, (args, kwargs)):
        out = fn(*args, **kwargs)
    seen = set()
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            cost.output_size_bytes += st.nbytes()
    return cost, out
