"""What the wrappers of kernels 6-8 share beside the build: when a call
goes through their ``torch.autograd.Function``, and the pieces of its
``vmap`` rules."""
from __future__ import annotations

import torch

__all__ = ["needs_autograd", "batch_first", "vmap_loop"]


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
