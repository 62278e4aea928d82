"""What the CUDA wrappers of kernels 6-8 share beside the build: the
autograd policy of their CUDA branches."""
from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a CUDA launch: the kernels write
    into fresh tensors through raw pointers, so a result would carry no
    gradient and ``backward()`` would silently give none upstream of it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: gradients through the CUDA kernels are not ported yet "
            "(ROADMAP.md §1 item 4 ports them); call it under torch.no_grad() "
            "or with detached inputs"
        )
