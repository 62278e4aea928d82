"""Per-shard water-filling threshold statistics: the sharded solve's kernel.

Wrapper around the CUDA kernel in ``csrc/sharded_waterfill.cu`` (design notes
there), which replaces the JAX reference's Pallas TPU kernel
``repro/kernels/sharded_waterfill.py:waterfill_level_stats``.  The sharded
K-Vib solve (``core.solver``) scores a 128-level ladder of candidate water
levels per pass with it:

  n_below[k] = #{a < levels[k]}
  n_floor[k] = #{a <= floors[k]}
  mid_sum[k] = sum of a over floors[k] < a < levels[k]

Dispatch is by the device of the tensors: on the CPU the wrapper computes the
plain PyTorch version (``kernels.ref.waterfill_stats_reference``); on a CUDA
device it launches the kernel or raises, with no fallback.  Launches are
counted in ``waterfill_level_stats.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._common import ticket_counters
from repro_torch.kernels.build import load_library

__all__ = ["waterfill_level_stats", "launch_counts", "reset_launch_counts"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("sharded_waterfill")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.wf_scratch_bytes.argtypes = [i64, i32]
    lib.wf_scratch_bytes.restype = i64
    lib.wf_num_counters.argtypes = [i64]
    lib.wf_num_counters.restype = i64
    lib.wf_level_stats.argtypes = [ptr, i64, ptr, ptr, i32, ptr, ptr, ptr, ptr]
    lib.wf_level_stats.restype = i32
    return lib


def _check_vector(name: str, t, device=None) -> int:
    if not isinstance(t, torch.Tensor) or t.dim() != 1:
        raise ValueError(f"{name} must be a 1-D tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.shape[0] < 1:
        raise ValueError(f"{name} must be non-empty")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.shape[0]


def waterfill_level_stats(
    scores: torch.Tensor, levels: torch.Tensor, floors: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scores (M,) f32, in any order, +inf and NaN entries counted below no
    level; levels / floors (L,) f32, in any order.  Returns ``(n_below,
    n_floor, mid_sum)``, each (L,) f32 (module docstring).  Counts are exact
    up to 2**24 scores.  On the GPU it is one kernel launch, and the result
    is bitwise repeatable (no float atomics)."""
    m = _check_vector("scores", scores)
    n_levels = _check_vector("levels", levels, scores.device)
    if _check_vector("floors", floors, scores.device) != n_levels:
        raise ValueError(f"floors must have shape ({n_levels},), got {tuple(floors.shape)}")
    if scores.device.type == "cpu":
        return ref.waterfill_stats_reference(scores, levels, floors)
    if m >= 2**31:
        raise ValueError(f"the CUDA kernel takes fewer than 2**31 scores, got {m}")
    lib = _lib()
    dev = scores.device
    out = torch.empty((3, n_levels), dtype=torch.float32, device=dev)
    n_scratch, n_counters = lib.wf_scratch_bytes(m, n_levels), lib.wf_num_counters(m)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = counters = None
        if n_scratch:  # more than one block: the partials and their tickets
            scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
            counters = ticket_counters(dev, stream, n_counters)
        rc = lib.wf_level_stats(
            scores.data_ptr(), m, levels.data_ptr(), floors.data_ptr(), n_levels,
            None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"waterfill_level_stats CUDA launch failed: cudaError {rc}")
    waterfill_level_stats.launches += 1
    return out[0], out[1], out[2]


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"waterfill_level_stats": waterfill_level_stats.launches}


def reset_launch_counts() -> None:
    waterfill_level_stats.launches = 0


reset_launch_counts()
