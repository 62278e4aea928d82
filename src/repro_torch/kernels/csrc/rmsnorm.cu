// RMSNorm over rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:27 rmsnorm
// (pallas_call :36).  For x (R, D) in f32 or bf16 and scale (D,) in f32 or
// bf16, with f32 math:
//
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + scale)
//
// written in x's dtype.  The zoo models call it for every rms_norm: two a
// layer and the final norm, at (B*S, d_model) in prefill and (B, d_model)
// in each decode step, per head at (rows, hd) for qk_norm, and over d_in in
// the Mamba2 block's gated norm (src/repro_torch/models/common.py).
//
// What bounds it on an H100: bytes.  Each element is read once, squared and
// summed, then scaled: ~4 operations per element against 4 (bf16) or 8
// (f32) bytes moved, far below the card's ~20 f32 operations per byte.  At
// decode's (8, d_model) the work is a few KB: the launch and one memory
// latency are all there is.
//
// Design.  The TPU kernel walks row blocks of 256 rows through VMEM and
// asserts R % block_rows == 0.  Here a group of lanes owns one row and any R
// is taken (rows past R have no group):
//   * one batch of loads: each lane issues its whole share of the row (up
//     to kVpl 16-byte vectors, 8 bf16 or 4 f32 each) and the matching
//     vectors of scale before any arithmetic, so a row costs one memory
//     latency; the row stays in registers for the reduction (a shuffle tree
//     within the group) and the scaling, and leaves as 16-byte stores;
//   * narrow rows share a warp: rows of up to 32 vectors (D <= 256 bf16,
//     <= 128 f32; qk_norm's D = 64) take 8 lanes each, four rows a warp;
//     rows of up to 128 vectors (smollm's 960 bf16) take a warp;
//   * rows of 129 to 2,048 vectors (960 f32, zamba2's 2,048 bf16 and its
//     Mamba2 gated norm's 4,096 f32, gemma2's 4,608) take a block a row,
//     ceil(vectors / 128) warps with up to 4 vectors a lane, the warps'
//     sums added in shared memory behind one barrier (a warp a row holding
//     8 vectors a lane takes so many registers that one block fits an SM);
//   * wider rows loop over batches of 256 vectors, each batch's loads
//     issued together: a pass that sums, then a pass that re-reads (from
//     L2) and writes;
//   * rows that are not 16-byte aligned, or whose D is not a multiple of
//     the vector, take scalar loads (any D) in two passes.
// The lane-group paths put eight warps in a block, so smollm's decode step
// (R = 8, D = 960) is one block.  What is left: at decode the launch itself
// (chip_smoke.py's timing floor, a 1-element add_, ~5 us on the card's
// event timer) dwarfs the row; a CUDA graph of the step removes it, not
// this kernel.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowThreads = 512;  // the widest block-a-row launch: 2,048 vectors

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

// One 16-byte vector of x (V elements) and the V matching values of scale,
// which take 8, 16 or 32 bytes (loaded as one 8-byte word or one or two
// 16-byte words).
template <typename T, typename S>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int SB = V * sizeof(S);
  static constexpr int SN = SB >= 16 ? SB / 16 : 1;
  using SW = typename std::conditional<(SB >= 16), uint4, uint2>::type;
  uint4 x;
  SW s[SN];
  __device__ __forceinline__ void load_x(const T* row, int i) {
    x = __ldg(reinterpret_cast<const uint4*>(row) + i);
  }
  __device__ __forceinline__ void load_s(const S* scale, int i) {
#pragma unroll
    for (int w = 0; w < SN; ++w) s[w] = __ldg(reinterpret_cast<const SW*>(scale) + i * SN + w);
  }
  __device__ __forceinline__ float sumsq() const {
    const T* e = reinterpret_cast<const T*>(&x);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fmaf(to_f(e[j]), to_f(e[j]), acc);
    return acc;
  }
  __device__ __forceinline__ void store(T* row, int i, float inv) const {
    const T* e = reinterpret_cast<const T*>(&x);
    const S* sc = reinterpret_cast<const S*>(s);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = from_f<T>((to_f(e[j]) * inv) * (1.f + to_f(sc[j])));
    reinterpret_cast<uint4*>(row)[i] = out;
  }
};

template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Vectorised rows: kLanes lanes a row, up to kVpl vectors a lane in one
// batch of loads; kLoop walks rows of any width in batches of kLanes * kVpl
// vectors (sum pass, then a load-and-write pass).
template <typename T, typename S, int kLanes, int kVpl, bool kLoop>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                       int R, int D, float eps) {
  using Vt = Vec<T, S>;
  constexpr int kRowsPerWarp = 32 / kLanes;
  constexpr int kBatch = kLanes * kVpl;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const int row = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRowsPerWarp + lane / kLanes;
  // Every lane of the warp reaches the shuffles; a group past R loads and
  // stores nothing (nv = 0 for it).
  const int nv = row < R ? D / Vt::V : 0;
  const T* xr = x + static_cast<int64_t>(row) * D;
  T* yr = y + static_cast<int64_t>(row) * D;
  Vt v[kVpl];

  if (!kLoop) {
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int i = sub + k * kLanes;
      if (i < nv) {
        v[k].load_x(xr, i);
        v[k].load_s(scale, i);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kVpl; ++k)
      if (sub + k * kLanes < nv) ss += v[k].sumsq();
    const float inv = rsqrtf(group_sum<kLanes>(ss) / static_cast<float>(D) + eps);
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int i = sub + k * kLanes;
      if (i < nv) v[k].store(yr, i, inv);
    }
    return;
  }

  float ss = 0.f;
  for (int b0 = 0; b0 < nv; b0 += kBatch) {
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int i = b0 + sub + k * kLanes;
      if (i < nv) v[k].load_x(xr, i);
    }
#pragma unroll
    for (int k = 0; k < kVpl; ++k)
      if (b0 + sub + k * kLanes < nv) ss += v[k].sumsq();
  }
  const float inv = rsqrtf(group_sum<kLanes>(ss) / static_cast<float>(D) + eps);
  for (int b0 = 0; b0 < nv; b0 += kBatch) {
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int i = b0 + sub + k * kLanes;
      if (i < nv) {
        v[k].load_x(xr, i);
        v[k].load_s(scale, i);
      }
    }
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int i = b0 + sub + k * kLanes;
      if (i < nv) v[k].store(yr, i, inv);
    }
  }
}

// Wide rows (128 < nv <= 2048 vectors): a block a row, W = ceil(nv / 128)
// warps, up to 4 vectors a lane in one batch of loads; the warps' sums meet
// in shared memory behind one barrier, and every thread adds them in the
// same order.
template <typename T, typename S>
__global__ void __launch_bounds__(kMaxRowThreads)
    rmsnorm_row_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                       int D, float eps) {
  using Vt = Vec<T, S>;
  constexpr int kVpl = 4;
  __shared__ float part[kMaxRowThreads / 32];
  const int nv = D / Vt::V;
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * D;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * D;
  Vt v[kVpl];
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) {
      v[k].load_x(xr, i);
      v[k].load_s(scale, i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kVpl; ++k)
    if (threadIdx.x + k * blockDim.x < nv) ss += v[k].sumsq();
  ss = group_sum<32>(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += part[w];
  const float inv = rsqrtf(total / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) v[k].store(yr, i, inv);
  }
}

// Rows that are not 16-byte aligned or whose D is not a multiple of the
// vector: a warp a row, scalar loads, two passes.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_scalar_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                          int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + static_cast<int64_t>(row) * D;
  T* yr = y + static_cast<int64_t>(row) * D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float t = to_f(xr[i]);
    ss += t * t;
  }
  const float inv = rsqrtf(group_sum<32>(ss) / static_cast<float>(D) + eps);
  for (int i = lane; i < D; i += 32) {
    yr[i] = from_f<T>((to_f(xr[i]) * inv) * (1.f + to_f(scale[i])));
  }
}

template <typename T, typename S, int kLanes, int kVpl, bool kLoop>
void launch_vec(const T* x, const S* scale, T* y, int R, int D, float eps, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarps * 32 / kLanes;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  rmsnorm_vec_kernel<T, S, kLanes, kVpl, kLoop><<<grid, kThreads, 0, stream>>>(x, scale, y, R, D, eps);
}

template <typename T, typename S>
void launch(const void* xv, const void* sv, void* yv, int R, int D, float eps,
            cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const S* scale = static_cast<const S*>(sv);
  T* y = static_cast<T*>(yv);
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(scale) & 15) == 0;
  if (!vec) {
    rmsnorm_scalar_kernel<T, S><<<dim3((R + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        x, scale, y, R, D, eps);
    return;
  }
  const int nv = D / V;
  if (nv <= 8 * 4) {
    launch_vec<T, S, 8, 4, false>(x, scale, y, R, D, eps, stream);
  } else if (nv <= 32 * 4) {
    launch_vec<T, S, 32, 4, false>(x, scale, y, R, D, eps, stream);
  } else if (nv <= kMaxRowThreads * 4) {
    const int threads = (nv + 127) / 128 * 32;
    rmsnorm_row_kernel<T, S><<<dim3(R), threads, 0, stream>>>(x, scale, y, D, eps);
  } else {
    launch_vec<T, S, 32, 8, true>(x, scale, y, R, D, eps, stream);
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
