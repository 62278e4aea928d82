"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel in ``fused_weighted_agg`` computes,
with the arithmetic the JAX reference falls back to off the TPU
(``repro/core/estimator.py``: ``w2 @ flat``).  The wrappers use them for
tensors on the CPU, the tests hold them against the JAX kernels run in
interpret mode, and ``chip_smoke.py`` holds the CUDA kernels against them on
the card.
"""
from __future__ import annotations

import torch

__all__ = ["multi_weighted_agg_reference", "cohort_agg_and_error_reference"]


def multi_weighted_agg_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, C) weight rows x (C, D) stacked deltas -> (M, D) f32."""
    return w.to(torch.float32) @ g.to(torch.float32)


def cohort_agg_and_error_reference(
    g: torch.Tensor, w: torch.Tensor, lam_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, D) cohort deltas, weights w (C,) and lam_c (C,) ->
    (d = sum_c w_c g_c (D,) f32, ||sum_c (w_c - lam_c) g_c||^2 () f32)."""
    w = w.to(torch.float32)
    w2 = torch.stack([w, w - lam_c.to(torch.float32)])
    out = w2 @ g.to(torch.float32)
    return out[0], (out[1] ** 2).sum()
