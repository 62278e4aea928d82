"""RMSNorm over rows: kernel 6 of the port.

Wrapper around the CUDA kernel in ``csrc/rmsnorm.cu`` (design notes there),
which replaces the JAX reference's Pallas TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm``:

  y = x * rsqrt(mean(x^2, -1) + eps) * (1 + scale)

for x (R, D) in f32 or bf16 and scale (D,), in f32 math, returned in
x.dtype.  The zoo models call it for every ``rms_norm``
(``models/common.py``).

The TPU wrapper asserts ``R % block_rows == 0``; this one takes any R and D
(one warp a row, rows past R have none, ragged D takes scalar loads).

Dispatch is by the device of the tensors: on the CPU the wrapper computes
the plain PyTorch version (``kernels.ref.rmsnorm_reference``); on a CUDA
device it launches the kernel or raises, with no fallback.  Launches are
counted in ``rmsnorm.launches``.

On both devices a call that needs a gradient, or runs under
``torch.func.grad`` or ``vmap``, goes through one ``torch.autograd.Function``
(``_common.needs_autograd``), so ``backward``, ``grad`` and ``vmap`` work
on either; any other call runs the Function's forward directly.  The backward is
the closed form in PyTorch (the TPU kernel has no backward kernel either):
with r = rsqrt(mean x^2 + eps), n = x r and gn = gy (1 + scale),

  gx = r (gn - n mean(gn n)),   gscale = sum over rows of gy n,

in f32, cast to x's and scale's dtypes (``rmsnorm_backward``), unrecorded
through ``_common.first_order``: a second differentiation raises.  The
vmap rule folds the vmapped axis into the rows when only x is batched (one
launch); a batched scale (a vmap over clients' parameters gives a (V, D)
scale, and the kernel takes one (D,) scale) loops: one launch per index of
the vmapped axis.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._common import batch_first, first_order, needs_autograd, vmap_loop
from repro_torch.kernels.build import load_library

__all__ = ["rmsnorm", "launch_counts", "reset_launch_counts"]

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("rmsnorm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_fwd.argtypes = [ptr, ptr, ptr, i32, i32, ctypes.c_float, i32, i32, ptr]
    lib.rmsnorm_fwd.restype = i32
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (R, D) f32|bf16, scale (D,) f32|bf16 -> (R, D) in x.dtype."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a 2-D (R, D) tensor")
    d = x.shape[1]
    if not isinstance(scale, torch.Tensor) or tuple(scale.shape) != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(getattr(scale, 'shape', ()))}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise ValueError(f"x and scale must be f32 or bf16, got {x.dtype} and {scale.dtype}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if needs_autograd(x, scale):
        return _RMSNorm.apply(x, scale, float(eps))
    return _RMSNorm.forward(x, scale, float(eps))


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    r, d = x.shape
    if d < 1 or r >= 2**31:
        raise ValueError(f"the CUDA kernel takes 0 < D and R < 2**31, got {(r, d)}")
    x, scale = x.contiguous(), scale.contiguous()
    y = torch.empty_like(x)
    if r == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), r, d, eps,
            int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rmsnorm CUDA launch failed: cudaError {rc}")
    rmsnorm.launches += 1
    return y


def rmsnorm_backward(x, scale, gy, eps: float = 1e-6):
    """(gx, gscale) of the module's docstring, in f32, cast to x's and
    scale's dtypes."""
    xf, gyf = x.to(torch.float32), gy.to(torch.float32)
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    n = xf * r
    gn = gyf * (1.0 + scale.to(torch.float32))
    gx = r * (gn - n * (gn * n).mean(-1, keepdim=True))
    gscale = (gyf * n).sum(0)
    return gx.to(x.dtype), gscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    """Kernel 6 (or its plain version on the CPU) with the closed-form
    backward and the vmap rule of the module's docstring."""

    @staticmethod
    def forward(x, scale, eps):
        if x.device.type == "cpu":
            return ref.rmsnorm_reference(x, scale, eps)
        return _launch(x, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, eps = inputs
        ctx.save_for_backward(x, scale)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        return (*first_order(rmsnorm_backward, x, scale, gy, eps=ctx.eps), None)

    @staticmethod
    def vmap(info, in_dims, x, scale, eps):
        x_dim, scale_dim, _ = in_dims
        if scale_dim is None:  # only x is batched: its rows take the vmapped axis
            shape = x.movedim(x_dim, 0).shape
            return _RMSNorm.apply(batch_first(x, x_dim), scale, eps).reshape(shape), 0
        return vmap_loop(_RMSNorm.apply, info, in_dims, x, scale, eps)


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"rmsnorm": rmsnorm.launches}


def reset_launch_counts() -> None:
    rmsnorm.launches = 0


reset_launch_counts()
