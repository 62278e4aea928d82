// RMSNorm over rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:27 rmsnorm
// (pallas_call :36).  For x (R, D) in f32 or bf16 and scale (D,) in f32 or
// bf16, with f32 math:
//
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + scale)
//
// written in x's dtype.  The dense zoo models call it for every rms_norm:
// two a layer and the final norm, at (B*S, d_model) in prefill and
// (B, d_model) in each decode step (src/repro_torch/models/common.py).
//
// What bounds it on an H100: bytes.  Each element is read once, squared and
// summed, then scaled: ~4 operations per element against 4 (bf16) or 8
// (f32) bytes moved, far below the card's ~20 f32 operations per byte.
//
// Design.  The TPU kernel walks row blocks of 256 rows through VMEM and
// asserts R % block_rows == 0.  Here one warp owns one row and any R is
// taken (rows past R have no warp):
//   * pass 1: the warp's lanes stride over the row with 16-byte loads
//     (8 bf16 or 4 f32 a lane) when the row is 16-byte aligned and D is a
//     multiple of the vector, else with scalar loads (any D), summing x^2 in
//     f32; a shuffle tree gives every lane the row's sum;
//   * pass 2: the same lanes read the row again (from L1, it was just read)
//     and write x * inv * (1 + scale) with the same vector width.
// Eight warps a block, so a block covers eight rows; R = 8 (a decode step
// of the 8-sequence batch) is one block.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                   int R, int D, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte vector
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + static_cast<int64_t>(row) * D;
  T* yr = y + static_cast<int64_t>(row) * D;

  float ss = 0.f;
  if (kVec) {
    for (int i = lane; i < D / V; i += 32) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = to_f(e[j]);
        ss += t * t;
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float t = to_f(xr[i]);
      ss += t * t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);

  if (kVec) {
    for (int i = lane; i < D / V; i += 32) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = from_f<T>((to_f(e[j]) * inv) * (1.f + to_f(scale[i * V + j])));
      }
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      yr[i] = from_f<T>((to_f(xr[i]) * inv) * (1.f + to_f(scale[i])));
    }
  }
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* y, int R, int D, float eps,
            cudaStream_t stream) {
  const dim3 grid((R + kWarps - 1) / kWarps);
  const bool vec = D % (16 / sizeof(T)) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (vec) {
    rmsnorm_kernel<T, S, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), R, D, eps);
  } else {
    rmsnorm_kernel<T, S, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), R, D, eps);
  }
}

}  // namespace

extern "C" {

// x (R, D) and y (R, D) contiguous, scale (D,) contiguous; x_bf16 / s_bf16
// select bf16 (1) or f32 (0) for x and y, and for scale.
int rmsnorm_fwd(const void* x, const void* scale, void* y, int R, int D, float eps,
                int x_bf16, int s_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    if (x_bf16 && s_bf16) launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, R, D, eps, s);
    else if (x_bf16) launch<__nv_bfloat16, float>(x, scale, y, R, D, eps, s);
    else if (s_bf16) launch<float, __nv_bfloat16>(x, scale, y, R, D, eps, s);
    else launch<float, float>(x, scale, y, R, D, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
