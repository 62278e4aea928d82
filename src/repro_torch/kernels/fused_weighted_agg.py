"""Fused weighted aggregation of stacked client deltas: the server's hot loop.

Wrappers around the CUDA kernels in ``csrc/fused_weighted_agg.cu`` (design
notes there), which replace the JAX reference's Pallas TPU kernels
``fused_multi_weighted_agg`` and ``fused_cohort_agg_and_error``
(``repro/kernels/fused_weighted_agg.py``).

Dispatch is by the device of the tensors: on the CPU a wrapper computes its
plain PyTorch version (``kernels.ref``); on a CUDA device it launches the
kernel or raises, with no fallback.  Unlike the reference, which only takes
``D % block_d == 0``, the kernels mask the ragged column edge, so any D is
valid.  Each wrapper counts its kernel launches in ``<wrapper>.launches``
(``launch_counts`` / ``reset_launch_counts``), so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library

__all__ = [
    "fused_multi_weighted_agg",
    "fused_cohort_agg_and_error",
    "launch_counts",
    "reset_launch_counts",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_weighted_agg")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fwa_num_tiles.argtypes = [i64, i32]
    lib.fwa_num_tiles.restype = i64
    lib.fwa_max_rows.argtypes = []
    lib.fwa_max_rows.restype = i32
    lib.fwa_multi_weighted_agg.argtypes = [ptr, i32, ptr, ptr, i32, i64, i32, ptr]
    lib.fwa_multi_weighted_agg.restype = i32
    lib.fwa_cohort_agg_and_error.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr,
    ]
    lib.fwa_cohort_agg_and_error.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {[str(d) for d in dtypes]}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_g(g: torch.Tensor) -> tuple[int, int]:
    if not isinstance(g, torch.Tensor) or g.dim() != 2:
        raise ValueError("g must be a 2-D (C, D) tensor")
    c, d = g.shape
    if c < 1 or d < 1:
        raise ValueError(f"g must be non-empty, got shape {(c, d)}")
    _check("g", g, (c, d), tuple(_DTYPE_CODES), g.device)
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g.device}")
    return c, d


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} CUDA launch failed: cudaError {rc}")


def fused_multi_weighted_agg(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g (C, D) f32|bf16 stacked flattened client updates; w (M, C) f32
    weight rows.  Returns (M, D) f32 — M weighted aggregates sharing one
    read of g.  Oracle mode uses M=2 (estimator weights, estimator-minus-
    target weights).  The CUDA kernel takes M <= 4."""
    c, d = _check_g(g)
    if not isinstance(w, torch.Tensor) or w.dim() != 2:
        raise ValueError("w must be a 2-D (M, C) tensor")
    m = w.shape[0]
    _check("w", w, (m, c), (torch.float32,), g.device)
    if g.device.type == "cpu":
        return ref.multi_weighted_agg_reference(g, w)
    lib = _lib()
    if not 1 <= m <= lib.fwa_max_rows():
        raise ValueError(f"the CUDA kernel takes 1 <= M <= {lib.fwa_max_rows()}, got M={m}")
    out = torch.empty((m, d), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.fwa_multi_weighted_agg(
            g.data_ptr(), _DTYPE_CODES[g.dtype], w.data_ptr(), out.data_ptr(),
            c, d, m, torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(rc, "fused_multi_weighted_agg")
    fused_multi_weighted_agg.launches += 1
    return out


def fused_cohort_agg_and_error(
    g: torch.Tensor, w: torch.Tensor, lam_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cohort-width estimate + squared error in one read of g.

    g (C, D) f32|bf16 stacked flattened cohort deltas; w (C,) f32 estimator
    weights (zero on padding slots); lam_c (C,) f32 objective weights at the
    cohort ids (zero on padding).  Returns (d (D,) f32, err () f32) with
    ``d = sum_c w_c g_c`` and ``err = ||sum_c (w_c - lam_c) g_c||^2``.  On
    the GPU the result is bitwise repeatable (no float atomics)."""
    c, d = _check_g(g)
    _check("w", w, (c,), (torch.float32,), g.device)
    _check("lam_c", lam_c, (c,), (torch.float32,), g.device)
    if g.device.type == "cpu":
        return ref.cohort_agg_and_error_reference(g, w, lam_c)
    lib = _lib()
    code = _DTYPE_CODES[g.dtype]
    d_out = torch.empty(d, dtype=torch.float32, device=g.device)
    err = torch.empty((), dtype=torch.float32, device=g.device)
    partials = torch.empty(lib.fwa_num_tiles(d, code), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.fwa_cohort_agg_and_error(
            g.data_ptr(), code, w.data_ptr(), lam_c.data_ptr(), d_out.data_ptr(),
            partials.data_ptr(), err.data_ptr(), c, d,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(rc, "fused_cohort_agg_and_error")
    fused_cohort_agg_and_error.launches += 1
    return d_out, err


fused_multi_weighted_agg.launches = 0
fused_cohort_agg_and_error.launches = 0
_WRAPPERS = (fused_multi_weighted_agg, fused_cohort_agg_and_error)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0
