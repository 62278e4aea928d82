"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref``).  Ported: the four aggregation kernels of
``fused_weighted_agg``; kernel 3 (``fused_weighted_agg``) is reached through
``kernels.ops`` so that the name here stays the module's.  ``ROADMAP.md``
queues the rest."""
from repro_torch.kernels.fused_weighted_agg import (
    dequantize_stacked,
    fused_cohort_agg_and_error,
    fused_dequant_cohort_agg,
    fused_multi_weighted_agg,
    launch_counts,
    quantize_stacked,
    reset_launch_counts,
)

__all__ = [
    "fused_multi_weighted_agg",
    "fused_cohort_agg_and_error",
    "fused_dequant_cohort_agg",
    "quantize_stacked",
    "dequantize_stacked",
    "launch_counts",
    "reset_launch_counts",
]
