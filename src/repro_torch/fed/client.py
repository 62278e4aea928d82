"""Client-side local training (Algorithm 1 lines 5-10).

``local_update`` runs R local SGD steps from the broadcast global params and
returns the paper's client update g_i = x^{t,0} - x^{t,R} (NOT the negated
direction: the server applies x <- x - eta_g * d with d the weighted average
of these updates, so g is a descent direction scaled by eta_l).  It is pure
(``torch.func.grad_and_value``), so the server vmaps it over clients.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.fed.tasks import tree_leaves, tree_map

__all__ = ["local_update", "update_norm"]


def local_update(params, loss_fn: Callable, batches, local_lr: float):
    """Run R local SGD steps; ``batches`` is a tuple of tensors that all
    lead with the step axis R (``(x, y)``, or ``(tokens, targets,
    aux_embeds)`` for a frontend arch); step r passes their r-th entries to
    ``loss_fn`` as one tuple.

    Returns (delta, final_loss) where delta = x^{t,0} - x^{t,R}.
    """
    grad_fn = torch.func.grad_and_value(loss_fn)
    p = params
    loss = None
    for r in range(batches[0].shape[0]):
        grads, loss = grad_fn(p, tuple(b[r] for b in batches))
        p = tree_map(lambda w, g: w - local_lr * g, p, grads)
        del grads  # freed before the next step's: one stack of gradients at a time
    delta = tree_map(lambda a, b: a - b, params, p)
    return delta, loss


def update_norm(delta) -> torch.Tensor:
    """||g_i|| over the flattened update pytree (float32 accumulation, leaves
    summed in the reference's tree order)."""
    leaves = tree_leaves(delta)
    total = leaves[0].float().square().sum()
    for leaf in leaves[1:]:
        total = total + leaf.float().square().sum()
    return total.sqrt()
