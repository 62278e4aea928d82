"""Flash attention: kernel 7 of the port.

Wrapper around the CUDA kernel in ``csrc/flash_attention.cu`` (design notes
there), which replaces the JAX reference's Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention``: online-softmax
attention with logits scaled by hd^-0.5, an optional soft cap applied before
the mask, causal and sliding-window masks that set logits to -2.3819763e38,
f32 accumulation, output in q's dtype.

Beyond the TPU kernel's (H, S, hd) it takes a leading batch axis, any
strides with hd contiguous (so the zoo models pass their
(B, S, heads, hd) projections as (B, heads, S, hd) views without a copy),
and ``q_groups``: query head h reads key/value head h // q_groups
(grouped-query attention without expanding K and V).  ``q_groups=1`` is
exactly the TPU kernel's function.  The TPU wrapper asserts
``S % block == 0``; this one masks the ragged tail instead: keys at or past
S_k never count, query rows at or past S_q are not written.

Dispatch is by the device of the tensors: on the CPU the wrapper computes
the plain PyTorch version (``kernels.ref.mha_reference``); on a CUDA device
it launches a kernel or raises, with no fallback.  Of the two CUDA kernels
the dtype and hd alone choose (``uses_tensor_cores``): bf16 with hd a
multiple of 16 up to 128 runs on the tensor cores, f32 and any other hd on
the CUDA cores.  Launches are counted in ``flash_attention.launches``,
those of the tensor-core kernel also in ``flash_attention.launches_tc``.
On ``meta`` tensors, while ``analysis.cost.count`` counts, the wrapper
allocates the output and charges the kernel's ``work`` to the count instead
of launching.

On both devices a call that needs a gradient, or runs under
``torch.func.grad`` or ``vmap``, goes through one ``torch.autograd.Function``
(``_common.needs_autograd``), so ``backward``, ``grad`` and ``vmap`` work
on either; any other call runs the Function's forward directly.  The backward
(``attention_backward``) is PyTorch code, a port of the reference's
``repro/kernels/ops.py:_fa_bwd`` (the TPU has no backward kernel either):
it recomputes the probabilities from q, k and the mask, takes the forward's
output for the row terms, multiplies the soft cap's 1 - tanh^2 in and zeroes
ds outside the mask, so a row with no valid key (whose output is the mean
of v) sends its gradient to v alone.  It builds the (S_q, S_k) probabilities
in f32, and it runs unrecorded through ``_common.first_order``: a second
differentiation raises.  The vmap rule folds the vmapped axis into B when
q, k and v are all batched (one launch); otherwise it loops, one launch
per index.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._common import (
    batch_first,
    counted_meta,
    meta_call,
    first_order,
    needs_autograd,
    vmap_loop,
)
from repro_torch.kernels.build import load_library

__all__ = [
    "flash_attention",
    "attention_backward",
    "attention_pairs",
    "work",
    "uses_tensor_cores",
    "launch_counts",
    "reset_launch_counts",
]

MAX_HEAD_DIM = 256  # the CUDA-core kernel
MAX_TC_HEAD_DIM = 128  # the tensor-core kernel (bf16, hd a multiple of 16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
            i32, i32, ctypes.c_float, ctypes.c_float]
    lib.flash_attention_fwd_cudacore.argtypes = [*args, i32, ptr]  # i32: bf16
    lib.flash_attention_fwd_tc.argtypes = [*args, ptr]
    for fn in (lib.flash_attention_fwd_cudacore, lib.flash_attention_fwd_tc):
        fn.restype = i32
    return lib


def uses_tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    """Whether a CUDA input of this dtype and head dim takes the tensor-core
    kernel (bf16, hd a multiple of 16 up to 128) rather than the CUDA-core
    one."""
    return dtype == torch.bfloat16 and hd % 16 == 0 and 0 < hd <= MAX_TC_HEAD_DIM


@functools.cache
def attention_pairs(s_q: int, s_k: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through: the work this input needs."""
    total = 0
    for q in range(s_q):
        hi = min(q, s_k - 1) if causal else s_k - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def work(q: torch.Tensor, k: torch.Tensor, causal: bool, window) -> tuple[int, int]:
    """The kernel's work at this input, ``(operations, bytes)``: 4 hd
    operations (two products of hd multiply-adds) per (query, key) pair the
    mask lets through, for every query head; q, k, v read and the output
    written once.  q (..., H, S_q, hd), k (..., KV, S_k, hd)."""
    b, (h, s_q, hd), (kv, s_k) = q.shape[:-3].numel(), q.shape[-3:], k.shape[-3:-1]
    pairs = attention_pairs(s_q, s_k, bool(causal), window)
    return 4 * b * h * pairs * hd, b * (2 * s_q * h + 2 * s_k * kv) * hd * q.element_size()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its pointer and (batch, head, seq) strides suit the
    tensor-core kernel's 16-byte copies, else a contiguous copy.  A ``meta``
    tensor has no pointer: its storage's base is taken as aligned, as the
    caching allocator's are."""
    es = t.element_size()
    ptr = t.storage_offset() * es if t.is_meta else t.data_ptr()
    if ptr % 16 == 0 and all(s * es % 16 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check(q, k, v, q_groups, window, softcap):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() not in (3, 4):
            raise ValueError(f"{name} must be a (H, S, hd) or (B, H, S, hd) tensor")
        if t.dim() != q.dim() or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share rank, dtype and device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must be f32 or bf16, got {q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    if int(q_groups) < 1 or q.shape[-3] != k.shape[-3] * int(q_groups):
        raise ValueError(
            f"q has {q.shape[-3]} heads, k {k.shape[-3]}: need q heads = k heads * q_groups "
            f"({q_groups})"
        )
    if q.shape[:-3] != k.shape[:-3] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or hd")
    if k.shape[-2] < 1:
        raise ValueError("k must hold at least one key")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not float(softcap) > 0.0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_groups: int = 1,
) -> torch.Tensor:
    """q (H, S_q, hd) or (B, H, S_q, hd); k, v (H / q_groups, S_k, hd) or
    (B, H / q_groups, S_k, hd); f32 or bf16, hd <= 256 on the GPU.  Returns
    q's shape and dtype (on the GPU with q's memory layout)."""
    _check(q, k, v, q_groups, window, softcap)
    if q.device.type not in ("cpu", "cuda") and not counted_meta(q):
        raise ValueError(f"unsupported device {q.device}")
    args = (q, k, v, bool(causal), None if window is None else int(window),
            None if softcap is None else float(softcap), int(q_groups))
    if needs_autograd(q, k, v):
        return _FlashAttention.apply(*args)
    return _FlashAttention.forward(*args)


def attention_backward(q, k, v, out, d_out, *, causal, window, softcap, q_groups):
    """Gradients (dq, dk, dv) of the attention above at (q, k, v), given
    its output ``out`` and the output's cotangent ``d_out``: the reference's
    ``_fa_bwd`` on the (..., heads, S, hd) layout, with dk and dv summed
    over the ``q_groups`` query heads that read each key/value head.  f32
    math; each gradient in its input's dtype."""
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if q_groups > 1:
        kf = kf.repeat_interleave(q_groups, dim=-3)
        vf = vf.repeat_interleave(q_groups, dim=-3)
    qf, do = q.to(torch.float32), d_out.to(torch.float32)
    scale = q.shape[-1] ** -0.5
    s_raw = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s_capped = s_raw if softcap is None else softcap * torch.tanh(s_raw / softcap)
    mask = ref.attention_mask(q.shape[-2], k.shape[-2], causal, window, q.device)
    p = torch.softmax(torch.where(mask, s_capped, ref.NEG), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    d_rows = (do * out.to(torch.float32)).sum(-1, keepdim=True)
    ds = p * (dp - d_rows)  # the gradient of the (masked, capped) logits
    if softcap is not None:
        ds = ds * (1.0 - torch.tanh(s_raw / softcap) ** 2)
    ds = torch.where(mask, ds, 0.0)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    if q_groups > 1:
        dk, dv = (t.unflatten(-3, (-1, q_groups)).sum(-3) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Kernel 7 (or its plain version on the CPU) with ``attention_backward``
    and the vmap rule of the module's docstring."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap, q_groups):
        if q.device.type == "cpu":
            return ref.mha_reference(
                q, k, v, causal=causal, window=window, softcap=softcap, q_groups=q_groups
            )
        if q.shape[-1] > MAX_HEAD_DIM:
            raise ValueError(f"the CUDA kernel takes hd <= {MAX_HEAD_DIM}, got {q.shape[-1]}")
        return _launch(q, k, v, causal, window, softcap, q_groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap, q_groups = inputs
        ctx.save_for_backward(q, k, v, output)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, q_groups=q_groups)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        grads = first_order(attention_backward, q, k, v, out, d_out, **ctx.kw)
        return (*grads, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, *rest):
        dims = in_dims[:3]
        if any(d is None for d in dims):
            return vmap_loop(_FlashAttention.apply, info, in_dims, q, k, v, *rest)
        if q.dim() == 4:  # (H, S, hd) each: the vmapped axis is B
            return _FlashAttention.apply(*(t.movedim(d, 0) for t, d in zip((q, k, v), dims)), *rest), 0
        shape = q.movedim(dims[0], 0).shape
        out = _FlashAttention.apply(*(batch_first(t, d) for t, d in zip((q, k, v), dims)), *rest)
        return out.reshape(shape), 0


def _launch(q, k, v, causal, window, softcap, q_groups) -> torch.Tensor:
    """Launch the kernel ``uses_tensor_cores`` picks."""
    hd = q.shape[-1]
    tc = uses_tensor_cores(q.dtype, hd)
    batched = q.dim() == 4
    q4, k4, v4 = (t if batched else t.unsqueeze(0) for t in (q, k, v))
    q4, k4, v4 = (t if t.stride(-1) == 1 else t.contiguous() for t in (q4, k4, v4))
    if tc:
        q4, k4, v4 = (_aligned(t) for t in (q4, k4, v4))
    out = torch.empty_like(q4)  # a dense q keeps its layout (preserve_format)
    b, h, s_q, _ = q4.shape
    s_k = k4.shape[2]
    if max(b, s_q, s_k) >= 2**31 or h > 65535:
        raise ValueError(f"unsupported shape q {tuple(q4.shape)}, k {tuple(k4.shape)}")
    if out.numel() == 0:
        return out if batched else out.squeeze(0)
    if q4.is_meta:  # a dry run: nothing to launch on
        meta_call("flash_attention", (q4, k4, v4), work(q4, k4, causal, window))
        return out if batched else out.squeeze(0)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q4, k4, v4, out) for s in t.stride()[:3]))
    lib = _lib()
    # The CUDA-core entry point alone takes a dtype flag, before the stream.
    fn, dtype_flag = (
        (lib.flash_attention_fwd_tc, ())
        if tc
        else (lib.flash_attention_fwd_cudacore, (int(q.dtype == torch.bfloat16),))
    )
    with torch.cuda.device(q.device):
        rc = fn(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(), strides,
            b, h, q_groups, s_q, s_k, hd, int(bool(causal)),
            0 if window is None else int(window), 0.0 if softcap is None else float(softcap),
            float(hd**-0.5), *dtype_flag,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention CUDA launch failed: cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.launches_tc += int(tc)
    return out if batched else out.squeeze(0)


def launch_counts() -> dict:
    """Kernel launches since the last reset (both kernels; the tensor-core
    kernel's alone are ``flash_attention.launches_tc``)."""
    return {"flash_attention": flash_attention.launches}


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_tc = 0


reset_launch_counts()
