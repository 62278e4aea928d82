"""What the kernel wrappers share beside the build: the ticket counters of
the kernels that finish a cross-block sum in their own launch (kernels
2-5); for kernels 6-8 when a call goes through their
```torch.autograd.Function``, the pieces of its ``vmap`` rules and the
first-order-only call of its PyTorch backward; and for kernels 6-8 on
``meta`` tensors (``analysis.cost.count``'s dry run), the charge of a
kernel's work to the active count in place of a launch."""
from __future__ import annotations

import torch

__all__ = [
    "ticket_counters", "needs_autograd", "batch_first", "vmap_loop", "first_order",
    "counted_meta", "meta_call", "COUNTS",
]

# The counts being taken (``analysis.cost.counting``), innermost last.  A
# kernel wrapper called on ``meta`` tensors charges its kernel's work to the
# innermost one (``meta_call``).  Each count pushes itself for the
# length of its run and pops itself after.
COUNTS: list = []


def counted_meta(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``meta`` tensor while a count is taken: the one
    device besides the CPU and CUDA that the wrappers take (the dry run's);
    outside a count a ``meta`` tensor is refused as any other device."""
    return bool(COUNTS) and t.is_meta


def meta_call(name: str, tensors, work: tuple) -> None:
    """A kernel call on ``meta`` tensors: nothing is launched.  ``tensors``
    are the call's tensor arguments (all ``meta``: a real one would need a
    real launch); ``work`` is the kernel's ``(operations, bytes)``, its
    bytes read once and written once, charged to the innermost active
    count.  The wrapper has allocated the kernel's outputs with their
    shapes and dtypes; they hold no values."""
    if not all(t.is_meta for t in tensors):
        raise ValueError(f"{name}: meta and real tensors in one call")
    if COUNTS:
        COUNTS[-1].charge(name, *work)


# Ticket counters, one int32 buffer per (device, stream).  A kernel's last
# block to finish finds itself by an atomic ticket on a counter and sets it
# back to 0, so every launch finds its counters at 0: launches in order on
# one stream share them, and launches on two streams, which may overlap,
# never do.  Zeroed when allocated; grown (a new zeroed buffer, on the same
# stream) when a launch needs more than the stream's buffer holds.
_COUNTERS: dict = {}


def ticket_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters, all 0 between launches, for launches
    on ``stream`` (a raw CUDA stream handle) of ``device``."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
    return buf


def needs_autograd(*tensors) -> bool:
    """Whether a call must go through its ``torch.autograd.Function``: grad
    mode on with an input that requires grad, or a ``torch.func`` transform
    (``grad``, ``vmap``) active.  Otherwise the wrappers call the Function's
    ``forward`` directly: ``Function.apply`` binds its arguments through
    ``inspect.signature`` on every call, host time that a host-bound decode
    step would pay once a kernel-6 call (``chip_smoke.py`` measures both)."""
    if torch._C._are_functorch_transforms_active():
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def batch_first(t: torch.Tensor, bdim: int) -> torch.Tensor:
    """``t`` with its vmapped axis ``bdim`` folded into its leading axis:
    (..., V at bdim, ...) -> (V * t.shape'[0], ...) where t' is ``t`` with
    the axis moved to the front.  A view where the strides allow it."""
    return t.movedim(bdim, 0).flatten(0, 1)


def vmap_loop(apply, info, in_dims, *args):
    """The vmap rule that cannot fold: call ``apply`` once per index of the
    vmapped axis, on that slice of each batched argument (the others as
    they are), and stack the results along a new axis 0.  ``apply`` returns
    a tensor or a tuple of tensors; so does the rule, with its out_dims."""
    outs = [
        apply(*(a if d is None else a.select(d, i) for a, d in zip(args, in_dims)))
        for i in range(info.batch_size)
    ]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
    return torch.stack(outs), 0


class _FirstOrder(torch.autograd.Function):
    """``fn(*tensors, **kw)`` as a Function: its forward runs with grad mode
    off, and its backward raises."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, kw, *tensors):
        return fn(*tensors, **kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name = inputs[0].__qualname__

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.name} is first-order only: a kernel's PyTorch backward is not "
            "differentiable again (a second-order gradient through kernels 6 and 7 "
            "is not ported)"
        )


def _sole_differentiation(tensors) -> bool:
    """Whether nothing can differentiate what a backward returns: a plain
    ``backward`` without ``create_graph``, or the one ``torch.func`` grad
    level (``vmap`` around it or not) over tensors that no autograd graph
    outside it tracks."""
    if not torch._C._are_functorch_transforms_active():
        return not torch.is_grad_enabled()
    try:
        from torch._C._functorch import TransformType, get_unwrapped, is_functorch_wrapped_tensor
        from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters
    except ImportError:  # a torch without these: the recorded path, which raises
        return False
    keys = [i.key() for i in retrieve_all_functorch_interpreters()]
    if sum(k in (TransformType.Grad, TransformType.Jvp) for k in keys) != 1:
        return False
    for t in tensors:
        while is_functorch_wrapped_tensor(t):
            t = get_unwrapped(t)
        if t.requires_grad:
            return False
    return True


def first_order(fn, *tensors, **kw):
    """Run a kernel's PyTorch backward ``fn(*tensors, **kw)`` unrecorded,
    and fail loudly if anything differentiates what it returns.

    ``torch.func.grad`` differentiates with ``create_graph``, so a backward
    recorded as it runs keeps every layer's f32 intermediates alive until
    the whole backward ends (kernel 7's (S_q, S_k) probabilities in
    whisper's encoder: the card's 80 GB at C = 8).  Where this is the sole
    differentiation (``_sole_differentiation``: the zoo round's
    ``vmap(grad)``), ``fn`` runs under ``no_grad`` and its result carries
    no graph.  Anywhere else (``grad`` of ``grad``, ``create_graph`` and a
    second ``backward``) it runs as the forward of a Function whose
    backward raises, where ``no_grad`` would silently drop this term from
    the second-order gradient (``hessian``, forward over reverse, raises
    for the missing ``jvp``).  The Function's result requires grad, which
    makes the backward ops after it record, several GB at the peak of
    whisper's round, so the sole level does without it."""
    if _sole_differentiation(tensors):
        with torch.no_grad():
            return fn(*tensors, **kw)
    return _FirstOrder.apply(fn, kw, *tensors)
