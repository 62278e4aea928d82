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
device it launches the kernel or raises, with no fallback.  Launches are
counted in ``ssd_scan.launches``.

On both devices a call that needs a gradient, or runs under
``torch.func.grad`` or ``vmap``, goes through one ``torch.autograd.Function``
(``_common.needs_autograd``), so ``backward``, ``grad`` and ``vmap`` work
on either; any other call runs the Function's forward directly.  The backward
is PyTorch code (the TPU kernel has no backward kernel either):
``torch.func.vjp`` of the plain version, recomputed from the saved inputs,
pulled back from y's cotangent and, with ``return_state``, the final
state's; an output that was not used gets zeros.  The plain version masks
above the diagonal before its exp, so the gradient stays finite where
cum_t - cum_s would overflow under strong decays.  The vmap rule folds the
vmapped axis into the leading axis of x, da, b and c when all four are
batched (one launch; b and c stay shared per batch row, as the ratio of
x's rows to b's is unchanged); otherwise it loops, one launch per index.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._common import batch_first, needs_autograd, vmap_loop
from repro_torch.kernels.build import load_library

__all__ = ["ssd_scan", "launch_counts", "reset_launch_counts"]

MAX_CHUNK = 128  # the CUDA kernel's largest chunk (its (Q, Q) score tile)
MAX_STATE = 128  # the CUDA kernel's largest N (its state update's row tiles a warp)
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    args = (x, da, b, c, int(chunk), bool(return_state))
    if needs_autograd(x, da, b, c):
        return _SSDScan.apply(*args)
    return _SSDScan.forward(*args)


def _launch(x, da, b, c, chunk: int, return_state: bool):
    s, hd = x.shape[-2:]
    q = min(chunk, s)
    if q > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks of at most {MAX_CHUNK} steps, got {q}")
    x4 = x if x.dim() == 4 else x.unsqueeze(1)
    x4 = x4 if x4.stride(-1) == 1 else x4.contiguous()
    da4 = (da if da.dim() == 3 else da.unsqueeze(1)).to(torch.float32)
    b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (b, c))
    bh, n = x4.shape[0] * x4.shape[1], b.shape[2]
    if n > MAX_STATE:
        raise ValueError(f"the CUDA kernel takes a state of at most {MAX_STATE} columns, got N={n}")
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


class _SSDScan(torch.autograd.Function):
    """Kernel 8 (or its plain version on the CPU) with the recomputing
    backward and the vmap rule of the module's docstring."""

    @staticmethod
    def forward(x, da, b, c, chunk, return_state):
        if x.device.type == "cpu":
            return ref.ssd_scan_reference(x, da, b, c, chunk=chunk, return_state=return_state)
        return _launch(x, da, b, c, chunk, return_state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, da, b, c, chunk, return_state = inputs
        ctx.save_for_backward(x, da, b, c)
        ctx.chunk, ctx.return_state = chunk, return_state
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None

    @staticmethod
    def backward(ctx, *cotangents):
        def plain(*inputs):
            return ref.ssd_scan_reference(
                *inputs, chunk=ctx.chunk, return_state=ctx.return_state
            )

        outputs, pullback = torch.func.vjp(plain, *ctx.saved_tensors)
        if not ctx.return_state:
            outputs = (outputs,)
        cot = tuple(torch.zeros_like(o) if g is None else g for o, g in zip(outputs, cotangents))
        return (*pullback(cot if ctx.return_state else cot[0]), None, None)

    @staticmethod
    def vmap(info, in_dims, x, da, b, c, chunk, return_state):
        dims = in_dims[:4]
        if any(d is None for d in dims):
            return vmap_loop(_SSDScan.apply, info, in_dims, x, da, b, c, chunk, return_state)
        shape = x.movedim(dims[0], 0).shape
        out = _SSDScan.apply(
            *(batch_first(t, d) for t, d in zip((x, da, b, c), dims)), chunk, return_state
        )
        if not return_state:
            return out.reshape(shape), 0
        y, state = out
        return (y.reshape(shape), state.unflatten(0, (info.batch_size, -1))), (0, 0)


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"ssd_scan": ssd_scan.launches}


def reset_launch_counts() -> None:
    ssd_scan.launches = 0


reset_launch_counts()
