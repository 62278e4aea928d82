"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref``).  Ported: ``fused_multi_weighted_agg`` and
``fused_cohort_agg_and_error``; ``ROADMAP.md`` queues the rest."""
from repro_torch.kernels.fused_weighted_agg import (
    fused_cohort_agg_and_error,
    fused_multi_weighted_agg,
    launch_counts,
    reset_launch_counts,
)

__all__ = [
    "fused_multi_weighted_agg",
    "fused_cohort_agg_and_error",
    "launch_counts",
    "reset_launch_counts",
]
