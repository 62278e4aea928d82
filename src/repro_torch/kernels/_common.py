"""What the kernel wrappers share beside the build: the ticket counters of
the kernels that finish a cross-block sum in their own launch (kernels
2-5), and for kernels 6-8 when a call goes through their
``torch.autograd.Function`` and the pieces of its ``vmap`` rules."""
from __future__ import annotations

import torch

__all__ = ["ticket_counters", "needs_autograd", "batch_first", "vmap_loop"]

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
