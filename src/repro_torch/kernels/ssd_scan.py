"""Mamba2 SSD chunked scan: kernel 8 of the port.

Wrapper around the CUDA kernel in ``csrc/ssd_scan.cu`` (design notes
there), which replaces the JAX reference's Pallas TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan``: per chunk of Q = min(chunk, S)
steps, y = (C·Bᵀ ∘ decay)·X + (C ∘ e^cum)·Sᵀ with the (hd, N) state S
carried across chunks in f32, y in x's dtype.

Beyond the TPU kernel's (BH, S, hd) and (BH, S, N) it takes:

* x as (B, H, S, hd), any strides with hd contiguous: the model passes its
  (B, S, H, hd) inputs as a transposed view, and y comes back with x's
  memory layout, so neither side makes a transpose copy;
* b and c as (R, S, N) with R dividing BH, row i reading b[i // (BH / R)]:
  (B, S, N) shares B and C across the H heads of a batch row (zamba2's
  n_groups = 1) without a 64-fold repeat;
* any S: the TPU wrapper asserts S % Q == 0 and pads da to 128 lanes; here
  a ragged last chunk is zero-filled (zero input and zero log decay leave y
  and the state unchanged);
* ``return_state``: the final state (BH, hd, N) f32, which prefill needs
  for decode (the TPU kernel drops it).

Dispatch is by the device of the tensors: on the CPU the wrapper computes
the plain PyTorch version (``kernels.ref.ssd_scan_reference``); on a CUDA
device it launches the kernel or raises, with no fallback.  The kernel is
forward-only: with grad mode on, an input that requires grad raises
(``_common.refuse_grad``).  Launches are counted in ``ssd_scan.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._common import refuse_grad
from repro_torch.kernels.build import load_library

__all__ = ["ssd_scan", "launch_counts", "reset_launch_counts"]

MAX_CHUNK = 128  # the CUDA kernel's largest chunk (its (Q, Q) score tile)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("ssd_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
    lib.ssd_scan_fwd.restype = i32
    return lib


def _check(x, da, b, c, chunk) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() not in (3, 4):
        raise ValueError("x must be a (BH, S, hd) or (B, H, S, hd) tensor")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    if not isinstance(da, torch.Tensor) or da.shape != x.shape[:-1] or da.dtype not in _DTYPES:
        raise ValueError(f"da must be an f32 or bf16 tensor of shape {tuple(x.shape[:-1])}")
    for name, t in (("b", b), ("c", c)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3 or t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be an f32 or bf16 (R, S, N) tensor")
    if b.shape != c.shape or b.dtype != c.dtype:
        raise ValueError(f"b and c differ: {tuple(b.shape)}/{b.dtype} vs {tuple(c.shape)}/{c.dtype}")
    s, hd = x.shape[-2:]
    bh = x.shape[:-2].numel()
    if min(s, hd, b.shape[0], b.shape[2]) < 1 or b.shape[1] != s or bh % b.shape[0]:
        raise ValueError(
            f"x {tuple(x.shape)} and b {tuple(b.shape)}: need S, hd, N >= 1, b's S equal to x's "
            "and b's rows dividing x's B*H"
        )
    if any(t.device != x.device for t in (da, b, c)):
        raise ValueError("x, da, b and c must be on one device")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def ssd_scan(
    x: torch.Tensor,
    da: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """x (BH, S, hd) or (B, H, S, hd) f32|bf16 dt-weighted inputs; da
    x.shape[:-1] log decays; b, c (R, S, N) f32|bf16, R dividing BH.
    Returns y (x's shape and dtype; on the GPU with x's memory layout) and,
    with ``return_state``, the final state (BH, hd, N) f32."""
    _check(x, da, b, c, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_reference(x, da, b, c, chunk=chunk, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    refuse_grad("ssd_scan", x, da, b, c)
    s, hd = x.shape[-2:]
    q = min(int(chunk), s)
    if q > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks of at most {MAX_CHUNK} steps, got {q}")
    x4 = x if x.dim() == 4 else x.unsqueeze(1)
    x4 = x4 if x4.stride(-1) == 1 else x4.contiguous()
    da4 = (da if da.dim() == 3 else da.unsqueeze(1)).to(torch.float32)
    b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (b, c))
    bh, n = x4.shape[0] * x4.shape[1], b.shape[2]
    if max(bh, s) >= 2**31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}")
    y4 = torch.empty_like(x4)  # a dense x keeps its layout (preserve_format)
    state = torch.empty((bh, hd, n), dtype=torch.float32, device=x.device) if return_state else None
    strides = (ctypes.c_int64 * 13)(
        *x4.stride()[:3], *y4.stride()[:3], *da4.stride(), *b.stride()[:2], *c.stride()[:2]
    )
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.ssd_scan_fwd(
            x4.data_ptr(), da4.data_ptr(), b.data_ptr(), c.data_ptr(), y4.data_ptr(),
            None if state is None else state.data_ptr(), strides,
            bh, x4.shape[1], bh // b.shape[0], s, hd, n, q,
            int(x.dtype == torch.bfloat16), int(b.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan CUDA launch failed: cudaError {rc}")
    ssd_scan.launches += 1
    y = y4 if x.dim() == 4 else y4.squeeze(1)
    return (y, state) if return_state else y


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"ssd_scan": ssd_scan.launches}


def reset_launch_counts() -> None:
    ssd_scan.launches = 0


reset_launch_counts()
