"""Recompute in the backward (gradient checkpointing) that composes with
``torch.func``: the port's counterpart of the reference's ``jax.checkpoint``
on the layer-group body (``cfg.remat == "full"``) and on the sLSTM segments
(``cfg.slstm_segment > 0``).

``torch.utils.checkpoint`` runs on saved-tensor hooks, which
``torch.func.grad`` and ``vmap`` refuse, and every zoo round differentiates
under ``vmap(grad)``.  ``recompute(fn, *args)`` is a
``torch.autograd.Function`` in the functorch form (``setup_context``, a
``vmap`` rule that runs ``fn`` under ``vmap``): its forward runs ``fn`` and
records nothing of it, it saves only ``fn``'s tensor inputs, and its
backward runs ``fn`` again from them and returns the cotangents of every
input (the parameters ``fn`` reads among them: every tensor ``fn`` reads
must be among its arguments).

Which differentiation the backward sees decides how it recomputes:

* a plain ``backward()``: ``fn`` again under ``enable_grad`` on detached
  inputs, then ``torch.autograd.grad``, with ``create_graph`` when the
  outer backward has it;
* the zoo round's ``torch.func.grad`` (``vmap`` around it or not), when it
  is the sole differentiation (``kernels._common._sole_differentiation``):
  the backward unwraps its tensors from that grad level, steps below it
  (``interpreter.lower()``) and differentiates ``fn`` there (``_vjp``).
  The recomputed body is then differentiated at one grad level, as it is
  without recompute, so the PyTorch backwards of kernels 6 and 7 inside it
  still run unrecorded (``kernels._common.first_order``).  Opening a grad
  level on top of the round's would make two, and send them through the
  recorded Function that keeps their f32 intermediates;
* anything else (``grad`` of ``grad``, ``grad`` outside ``vmap``): ``_vjp``
  at the current levels, which record it for the outer ones.

A call that takes no gradient (no ``torch.func`` grad level, and grad
mode off or no input requiring grad: ``no_grad``, serving, the gate's
scoring, ``vmap`` alone) calls ``fn`` directly.  The values
are those of ``fn`` run once: the forward and the recompute run the same
operations on the same inputs.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from repro_torch.kernels._common import _sole_differentiation

__all__ = ["recompute"]


def _vjp(fn, tensors, grads):
    """The cotangents of ``fn``'s inputs: ``torch.func.grad`` of the sum of
    its outputs' inner products with ``grads`` (None: no cotangent), which
    passes each cotangent through exactly (a product with 1.0).  Unlike
    ``torch.func.vjp``, the backward runs inside the grad level, so a
    recompute nested in ``fn`` finds its saved tensors alive; and it runs
    with a graph, as the round's own grad does (some formulas depend on
    grad mode: silu's backward differs in the last bits without)."""
    wrt = tuple(i for i, t in enumerate(tensors) if t.is_floating_point())

    def inner(*ins):
        outs = fn(*ins)
        terms = [(o * g).sum() for o, g in zip(outs, grads) if g is not None]
        if len(terms) == 1:
            return terms[0]
        return torch.stack([t.to(torch.float32) for t in terms]).sum()

    if not wrt or all(g is None for g in grads):
        return tuple(None for _ in tensors)
    got = dict(zip(wrt, torch.func.grad(inner, argnums=wrt)(*tensors)))
    return tuple(got.get(i) for i in range(len(tensors)))


def _plain_backward(fn, tensors, grads):
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(t.is_floating_point()) for t in tensors]
        outs = fn(*ins)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
    wrt = [i for i in ins if i.requires_grad]
    got = torch.autograd.grad(
        [o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True, create_graph=create
    )
    it = iter(got)
    return tuple(next(it) if i.requires_grad else None for i in ins)


def _lowered_vjp(fn, tensors, grads):
    """``_vjp`` one grad level down, or None where that level is not the
    sole differentiation on top of the interpreter stack."""
    try:
        from torch._C._functorch import TransformType, _unwrap_for_grad, _wrap_for_grad
        from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter
    except ImportError:  # a torch without these: the generic path
        return None
    interp = retrieve_current_functorch_interpreter()
    if interp.key() != TransformType.Grad or not _sole_differentiation(tensors):
        return None
    level = interp.level()
    ins = [_unwrap_for_grad(t, level) for t in tensors]
    cts = [None if g is None else _unwrap_for_grad(g, level) for g in grads]
    with interp.lower():
        got = _vjp(fn, ins, cts)
    return tuple(None if g is None else _wrap_for_grad(g, level) for g in got)


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(fn, *tensors):
        return tuple(fn(*tensors))

    @staticmethod
    def vmap(info, in_dims, fn, *tensors):
        # Below the grad level that applied the Function (``vmap(grad)``),
        # only the outputs are wanted: ``fn`` under vmap, no Function.
        outs = torch.func.vmap(fn, in_dims=tuple(in_dims[1:]), randomness=info.randomness)(
            *tensors)
        return outs, (0,) * len(outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        fn, tensors = ctx.fn, ctx.saved_tensors
        if not torch._C._are_functorch_transforms_active():
            return (None, *_plain_backward(fn, tensors, grads))
        got = _lowered_vjp(fn, tensors, grads)
        return (None, *(_vjp(fn, tensors, grads) if got is None else got))


def _differentiated(tensors) -> bool:
    """Whether a gradient can be taken through ``tensors``: a
    ``torch.func`` grad or jvp level is active, or grad mode is on and one
    of them requires grad (``vmap`` alone takes none)."""
    if torch._C._are_functorch_transforms_active():
        from torch._C._functorch import TransformType
        from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters

        if any(i.key() in (TransformType.Grad, TransformType.Jvp)
               for i in retrieve_all_functorch_interpreters()):
            return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward instead
    of kept.  ``args``: tensors, or dicts/lists/tuples of them, and other
    values passed through; ``fn`` returns a tensor or a tuple of tensors
    and None (a None output stays None).  Every tensor ``fn`` reads must be
    in ``args``: one it takes from a closure would be differentiated at
    the wrong level, or not at all."""
    flat, spec = pytree.tree_flatten(args)
    at = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]
    if not _differentiated([flat[i] for i in at]):
        return fn(*args)
    out_spec = []

    def flat_fn(*tensors):
        leaves = list(flat)
        for i, t in zip(at, tensors):
            leaves[i] = t
        out, spec_out = pytree.tree_flatten(fn(*pytree.tree_unflatten(leaves, spec)))
        is_tensor = [isinstance(x, torch.Tensor) for x in out]
        # A None output is a leaf of its own; keep no tensor past the call.
        out_spec[:] = [spec_out, is_tensor, [None if t else x for x, t in zip(out, is_tensor)]]
        return tuple(x for x, t in zip(out, is_tensor) if t)

    outs = iter(_Recompute.apply(flat_fn, *(flat[i] for i in at)))
    spec_out, is_tensor, rest = out_spec
    return pytree.tree_unflatten([next(outs) if t else x for x, t in zip(rest, is_tensor)],
                                 spec_out)
