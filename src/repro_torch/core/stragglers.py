"""Flattened-update helpers of ``repro/core/stragglers.py``.

Only ``flat_dim`` is ported, for the error-feedback residual of the
compressed round.  The fault layer itself (availability, deadline
stragglers, the buffered-async ring) waits for its slice (``ROADMAP.md``
queue 1, "Fault layer").
"""
from __future__ import annotations

import math

from repro_torch.fed.tasks import tree_leaves

__all__ = ["flat_dim"]


def flat_dim(tree) -> int:
    """Total element count of a dict of tensors."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))
