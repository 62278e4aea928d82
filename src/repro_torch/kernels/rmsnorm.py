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
device it launches the kernel or raises, with no fallback.  The kernel is
forward-only: with grad mode on, an input that requires grad raises
(``_common.refuse_grad``).  Launches are counted in ``rmsnorm.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._common import refuse_grad
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
    r, d = x.shape
    if not isinstance(scale, torch.Tensor) or tuple(scale.shape) != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(getattr(scale, 'shape', ()))}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise ValueError(f"x and scale must be f32 or bf16, got {x.dtype} and {scale.dtype}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.rmsnorm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    refuse_grad("rmsnorm", x, scale)
    if d < 1 or r >= 2**31:
        raise ValueError(f"the CUDA kernel takes 0 < D and R < 2**31, got {(r, d)}")
    x, scale = x.contiguous(), scale.contiguous()
    y = torch.empty_like(x)
    if r == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), r, d, float(eps),
            int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rmsnorm CUDA launch failed: cudaError {rc}")
    rmsnorm.launches += 1
    return y


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"rmsnorm": rmsnorm.launches}


def reset_launch_counts() -> None:
    rmsnorm.launches = 0


reset_launch_counts()
