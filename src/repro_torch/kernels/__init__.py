"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref``).  Ported: the four aggregation kernels of
``fused_weighted_agg``, ``sharded_waterfill.waterfill_level_stats``,
``rmsnorm.rmsnorm``, ``flash_attention.flash_attention`` (forward) and
``ssd_scan.ssd_scan``: every TPU kernel of the JAX package.  Kernels 3, 6, 7
and 8 share their module's name and are reached through ``kernels.ops``, so
that the name here stays the module's."""
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_weighted_agg as _fwa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import sharded_waterfill as _swf
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.fused_weighted_agg import (
    dequantize_stacked,
    fused_cohort_agg_and_error,
    fused_dequant_cohort_agg,
    fused_multi_weighted_agg,
    quantize_stacked,
)
from repro_torch.kernels.sharded_waterfill import waterfill_level_stats

__all__ = [
    "fused_multi_weighted_agg",
    "fused_cohort_agg_and_error",
    "fused_dequant_cohort_agg",
    "quantize_stacked",
    "dequantize_stacked",
    "waterfill_level_stats",
    "launch_counts",
    "reset_launch_counts",
]


def launch_counts() -> dict:
    """Kernel launches per wrapper, every kernel of the port, since the last
    reset."""
    return {
        **_fwa.launch_counts(), **_swf.launch_counts(), **_rms.launch_counts(),
        **_fa.launch_counts(), **_ssd.launch_counts(),
    }


def reset_launch_counts() -> None:
    for mod in (_fwa, _swf, _rms, _fa, _ssd):
        mod.reset_launch_counts()
