"""Fused weighted aggregation of stacked client deltas: the server's hot loop.

Wrappers around the CUDA kernels in ``csrc/fused_weighted_agg.cu`` (design
notes there), which replace the JAX reference's four Pallas TPU kernels of
``repro/kernels/fused_weighted_agg.py``: ``fused_weighted_agg``,
``fused_multi_weighted_agg``, ``fused_cohort_agg_and_error`` and
``fused_dequant_cohort_agg``.  The blockwise quantizer of the compressed
delta path (``quantize_stacked`` / ``dequantize_stacked``) is plain PyTorch,
as it is plain ``jnp`` in the reference.

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
from repro_torch.kernels._common import counted_meta, meta_call, ticket_counters
from repro_torch.kernels.build import load_library

__all__ = [
    "fused_weighted_agg",
    "fused_multi_weighted_agg",
    "fused_cohort_agg_and_error",
    "fused_dequant_cohort_agg",
    "quant_dtype",
    "quantize_stacked",
    "dequantize_stacked",
    "launch_counts",
    "reset_launch_counts",
]

# Element-type codes of the C interface.  fp8 crosses it as raw bytes.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)

# Saturation point of each delta width: int8 symmetric round-to-nearest keeps
# +-127 (the -128 code is unused, so the grid is symmetric); float8_e4m3fn's
# largest finite value is 448.
_QMAX = {"int8": 127.0, "fp8": 448.0}


def quant_dtype(name: str) -> torch.dtype:
    """torch dtype for a delta-width name ('int8' | 'fp8')."""
    if name == "int8":
        return torch.int8
    if name == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown delta dtype {name!r}")


def quantize_stacked(
    flat: torch.Tensor, *, dtype: str = "int8", scale_block: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric quantization of stacked (C, D) deltas.

    Each row is split into ``scale_block``-wide blocks with one f32 abs-max
    scale ``absmax / qmax`` per (row, block); D is zero-padded to a block
    multiple.  Zero blocks get scale 1.0.  int8 rounds half to even and clips
    to +-127; fp8 is the float8_e4m3fn cast.  Bitwise the reference's codes
    and scales.

    Returns (q (C, D_pad) int8|float8_e4m3fn, scales (C, nb) f32) with
    ``D_pad = nb * scale_block``.
    """
    qmax = _QMAX[dtype]
    c, d = flat.shape
    sb = int(scale_block)
    nb = -(-d // sb)
    flat = flat.to(torch.float32)
    if nb * sb != d:
        flat = torch.nn.functional.pad(flat, (0, nb * sb - d))
    blocks = flat.reshape(c, nb, sb)
    absmax = blocks.abs().amax(dim=2)
    scales = torch.where(absmax > 0.0, absmax / qmax, 1.0)
    scaled = blocks / scales[:, :, None]
    if dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(quant_dtype(dtype))
    return q.reshape(c, nb * sb), scales


def dequantize_stacked(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_stacked``: (C, D_pad) codes and (C, nb) scales
    -> (C, D_pad) f32."""
    c, d_pad = q.shape
    nb = scales.shape[1]
    return (q.to(torch.float32).reshape(c, nb, d_pad // nb) * scales[:, :, None]).reshape(c, d_pad)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_weighted_agg")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fwa_weighted_agg_partials.argtypes = [ptr, i32, i32, i64]
    lib.fwa_weighted_agg_partials.restype = i64
    lib.fwa_cohort_blocks.argtypes = [ptr, i32, i32, i64]
    lib.fwa_cohort_blocks.restype = i64
    lib.fwa_max_rows.argtypes = []
    lib.fwa_max_rows.restype = i32
    lib.fwa_multi_weighted_agg.argtypes = [ptr, i32, ptr, ptr, i32, i64, i32, ptr]
    lib.fwa_multi_weighted_agg.restype = i32
    lib.fwa_cohort_agg_and_error.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr,
    ]
    lib.fwa_cohort_agg_and_error.restype = i32
    lib.fwa_weighted_agg.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr]
    lib.fwa_weighted_agg.restype = i32
    lib.fwa_dequant_partials.argtypes = [ptr, i32, i32, i32, i64]
    lib.fwa_dequant_partials.restype = i64
    lib.fwa_dequant_cohort_agg.argtypes = [
        ptr, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, ptr,
    ]
    lib.fwa_dequant_cohort_agg.restype = i32
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


def _check_g(g: torch.Tensor, dtypes=_FLOAT_DTYPES, name: str = "g",
             meta: bool = False) -> tuple[int, int]:
    if not isinstance(g, torch.Tensor) or g.dim() != 2:
        raise ValueError(f"{name} must be a 2-D (C, D) tensor")
    c, d = g.shape
    if c < 1 or d < 1:
        raise ValueError(f"{name} must be non-empty, got shape {(c, d)}")
    _check(name, g, (c, d), dtypes, g.device)
    if g.device.type not in ("cpu", "cuda") and not (meta and counted_meta(g)):
        raise ValueError(f"unsupported device {g.device}")
    return c, d


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} CUDA launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_weighted_agg(g: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted aggregate and per-row squared norms in one read of g.

    g (C, D) f32|bf16 stacked flattened client updates; w (C,) f32 weights.
    Returns (d (D,) f32, sq_norms (C,) f32) with ``d = sum_c w_c g_c`` and
    ``sq_norms[c] = ||g_c||^2``.  On the GPU it is one kernel launch, and the
    norms are bitwise repeatable (no float atomics: the last block sums the
    blocks' partial norms in order)."""
    c, d = _check_g(g)
    _check("w", w, (c,), (torch.float32,), g.device)
    if g.device.type == "cpu":
        return ref.weighted_agg_reference(g, w)
    lib = _lib()
    code = _DTYPE_CODES[g.dtype]
    d_out = torch.empty(d, dtype=torch.float32, device=g.device)
    sq = torch.empty(c, dtype=torch.float32, device=g.device)
    stream = _stream(g)
    with torch.cuda.device(g.device):
        partials = torch.empty(
            lib.fwa_weighted_agg_partials(g.data_ptr(), code, c, d), dtype=torch.float32,
            device=g.device,
        )
        rc = lib.fwa_weighted_agg(
            g.data_ptr(), code, w.data_ptr(), d_out.data_ptr(), partials.data_ptr(),
            ticket_counters(g.device, stream, 1).data_ptr(), sq.data_ptr(), c, d, stream,
        )
    _raise_on(rc, "fused_weighted_agg")
    fused_weighted_agg.launches += 1
    return d_out, sq


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
            c, d, m, _stream(g),
        )
    _raise_on(rc, "fused_multi_weighted_agg")
    fused_multi_weighted_agg.launches += 1
    return out


def cohort_work(g: torch.Tensor) -> tuple[int, int]:
    """Kernel 2's work at g (C, D), ``(operations, bytes)``: two weighted
    sums (a multiply-add each an element) and the error row's square and
    sum; g read once, the (D,) f32 estimate and the scalar written, the
    two (C,) weight rows read."""
    c, d = g.shape
    return 4 * c * d + 2 * d, c * d * g.element_size() + 4 * d + 4 + 8 * c


def fused_cohort_agg_and_error(
    g: torch.Tensor, w: torch.Tensor, lam_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cohort-width estimate + squared error in one read of g.

    g (C, D) f32|bf16 stacked flattened cohort deltas; w (C,) f32 estimator
    weights (zero on padding slots); lam_c (C,) f32 objective weights at the
    cohort ids (zero on padding).  Returns (d (D,) f32, err () f32) with
    ``d = sum_c w_c g_c`` and ``err = ||sum_c (w_c - lam_c) g_c||^2``.  On
    the GPU it is one kernel launch, and the result is bitwise repeatable
    (no float atomics: the last block sums the blocks' partials in order).
    On ``meta`` tensors while a count is taken (the dry run's) it charges
    its work (``cohort_work``) and launches nothing."""
    c, d = _check_g(g, meta=True)
    _check("w", w, (c,), (torch.float32,), g.device)
    _check("lam_c", lam_c, (c,), (torch.float32,), g.device)
    if g.device.type == "cpu":
        return ref.cohort_agg_and_error_reference(g, w, lam_c)
    d_out = torch.empty(d, dtype=torch.float32, device=g.device)
    err = torch.empty((), dtype=torch.float32, device=g.device)
    if g.is_meta:  # a dry run: nothing to launch on
        meta_call("fused_cohort_agg_and_error", (g, w, lam_c), cohort_work(g))
        return d_out, err
    lib = _lib()
    code = _DTYPE_CODES[g.dtype]
    stream = _stream(g)
    with torch.cuda.device(g.device):
        partials = torch.empty(
            lib.fwa_cohort_blocks(g.data_ptr(), code, c, d), dtype=torch.float32, device=g.device
        )
        rc = lib.fwa_cohort_agg_and_error(
            g.data_ptr(), code, w.data_ptr(), lam_c.data_ptr(), d_out.data_ptr(),
            partials.data_ptr(), ticket_counters(g.device, stream, 1).data_ptr(), err.data_ptr(),
            c, d, stream,
        )
    _raise_on(rc, "fused_cohort_agg_and_error")
    fused_cohort_agg_and_error.launches += 1
    return d_out, err


def fused_dequant_cohort_agg(
    q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor, lam_c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compressed-width ``fused_cohort_agg_and_error``: widen the codes
    and aggregate in one read of q.

    q (C, D_pad) int8|float8_e4m3fn from ``quantize_stacked``; scales (C, nb)
    f32 with ``D_pad % nb == 0`` (scale block ``D_pad // nb``, any width);
    w / lam_c (C,) f32 as in ``fused_cohort_agg_and_error``.  With
    ``g = float(q) * scale`` per block, returns (d (D_pad,) f32,
    err () f32, sq_norms (C,) f32): ``d = sum_c w_c g_c``,
    ``err = ||sum_c (w_c - lam_c) g_c||^2`` and ``sq_norms[c] = ||g_c||^2``.
    On the GPU it is one kernel launch, and err and the norms are bitwise
    repeatable (the last block sums the partials in order)."""
    c, d = _check_g(q, _QUANT_DTYPES, "q")
    if not isinstance(scales, torch.Tensor) or scales.dim() != 2:
        raise ValueError("scales must be a 2-D (C, nb) tensor")
    nb = scales.shape[1]
    _check("scales", scales, (c, nb), (torch.float32,), q.device)
    if nb < 1 or d % nb:
        raise ValueError(f"D_pad={d} must be a positive multiple of nb={nb}")
    _check("w", w, (c,), (torch.float32,), q.device)
    _check("lam_c", lam_c, (c,), (torch.float32,), q.device)
    if q.device.type == "cpu":
        return ref.dequant_cohort_agg_reference(q, scales, w, lam_c)
    lib = _lib()
    code = _DTYPE_CODES[q.dtype]
    d_out = torch.empty(d, dtype=torch.float32, device=q.device)
    # sums[:C] are the norms, sums[C] the error; partials holds a (C + 1)-wide
    # row (padded to 16 bytes) for each block of the launch.
    sums = torch.empty(c + 1, dtype=torch.float32, device=q.device)
    stream = _stream(q)
    with torch.cuda.device(q.device):
        partials = torch.empty(
            lib.fwa_dequant_partials(q.data_ptr(), code, nb, c, d), dtype=torch.float32,
            device=q.device,
        )
        rc = lib.fwa_dequant_cohort_agg(
            q.data_ptr(), code, scales.data_ptr(), nb, w.data_ptr(), lam_c.data_ptr(),
            d_out.data_ptr(), partials.data_ptr(), ticket_counters(q.device, stream, 1).data_ptr(),
            sums.data_ptr(), c, d, stream,
        )
    _raise_on(rc, "fused_dequant_cohort_agg")
    fused_dequant_cohort_agg.launches += 1
    return d_out, sums[c], sums[:c]


_WRAPPERS = (
    fused_weighted_agg,
    fused_multi_weighted_agg,
    fused_cohort_agg_and_error,
    fused_dequant_cohort_agg,
)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0


reset_launch_counts()
