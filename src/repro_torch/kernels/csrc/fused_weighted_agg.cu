// Fused weighted aggregation of stacked client deltas, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels on the federated round's path
// (src/repro/kernels/fused_weighted_agg.py):
//
//   fwa_multi_weighted_agg    <- fused_multi_weighted_agg (:174, pallas_call :189)
//       out (M, D) f32 = w (M, C) f32 x g (C, D) f32|bf16, one read of g.
//       Oracle mode runs it with M = 2 (estimate row, estimate - target row).
//   fwa_cohort_agg_and_error  <- fused_cohort_agg_and_error (:221, pallas_call :248)
//       d (D,) f32 = sum_c w_c g_c and err () f32 = ||sum_c (w_c - lam_c) g_c||^2;
//       the error row is squared and reduced on chip and never written out.
//
// What bounds them on an H100: memory.  Each element of g is read once and
// used for 2M flops, about 1 flop per byte for f32 (the card needs ~20 f32
// flops per byte before the ALUs, not HBM at 3.35 TB/s, are the limit), so
// the time is the bytes of g over the memory rate.
//
// Design.  The TPU kernels walk a sequential grid over D and carry the
// squared-error sum in VMEM scratch from step to step.  Hopper's blocks run
// in parallel and in no order, so here:
//   * each block owns one tile of kThreads * V columns (V = 16 bytes / the
//     element size: 4 f32 or 8 bf16) and loops over all C rows, so every
//     element of g is loaded exactly once, by one thread;
//   * a thread keeps its M x V accumulators in registers in f32 and reads g
//     with 16-byte vector loads when every row starts 16-byte aligned
//     (D % V == 0 and an aligned base); otherwise it reads V scalars spaced
//     kThreads apart (still coalesced across the warp) and masks the ragged
//     edge, so any D is valid;
//   * the (M, C) weights are staged through shared memory kWChunk columns at
//     a time, so C is not bounded by shared memory;
//   * kernel 2's cross-block sum has no float atomics: each block reduces
//     its squared error (warp shuffles, then shared memory) into one partial,
//     and a second single-block pass sums the partials in a fixed order, so
//     repeated runs are bitwise identical.
// Not yet used: TMA, cp.async pipelining, wgmma.  The loads of the C rows
// are independent, so the unrolled row loop keeps several in flight.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError() (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kWChunk = 256;   // weight columns staged in shared memory per pass
constexpr int kSumThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// acc[m][k] += sum over rows c0 .. c0+nc-1 of ws[m][c - c0] * g[c, col_k].
// Aligned: the thread's columns are tile0 + threadIdx.x * V + k.
// Scalar:  the thread's columns are tile0 + threadIdx.x + k * kThreads.
template <typename T, int M, bool kAligned>
__device__ __forceinline__ void accumulate_rows(const T* __restrict__ g, int64_t D, int c0,
                                                int nc, int64_t tile0,
                                                float (*ws)[kWChunk],
                                                float (&acc)[M][Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  if (kAligned) {
    const int64_t col = tile0 + static_cast<int64_t>(threadIdx.x) * V;
    if (col >= D) return;  // D % V == 0: a vector is wholly in or out
    const T* p = g + static_cast<int64_t>(c0) * D + col;
#pragma unroll 4
    for (int c = 0; c < nc; ++c, p += D) {
      float x[V];
      load_vec(p, x);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float wm = ws[m][c];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[m][k] = fmaf(wm, x[k], acc[m][k]);
      }
    }
  } else {
    const int64_t col0 = tile0 + threadIdx.x;
    const T* p = g + static_cast<int64_t>(c0) * D + col0;
#pragma unroll 2
    for (int c = 0; c < nc; ++c, p += D) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (col0 + k * kThreads < D) {
          const float x = to_f32(p[k * kThreads]);
#pragma unroll
          for (int m = 0; m < M; ++m) acc[m][k] = fmaf(ws[m][c], x, acc[m][k]);
        }
      }
    }
  }
}

template <typename T, int M, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    multi_agg_kernel(const T* __restrict__ g, const float* __restrict__ w,
                     float* __restrict__ out, int C, int64_t D) {
  constexpr int V = Vec<T>::N;
  __shared__ float ws[M][kWChunk];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * (kThreads * V);
  float acc[M][V];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[m][k] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += kWChunk) {
    const int nc = min(kWChunk, C - c0);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < nc; i += kThreads) {
#pragma unroll
      for (int m = 0; m < M; ++m) ws[m][i] = w[static_cast<int64_t>(m) * C + c0 + i];
    }
    __syncthreads();
    accumulate_rows<T, M, kAligned>(g, D, c0, nc, tile0, ws, acc);
  }

  if (kAligned) {
    const int64_t col = tile0 + static_cast<int64_t>(threadIdx.x) * V;
    if (col < D) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int k = 0; k < V; k += 4)
          *reinterpret_cast<float4*>(out + m * D + col + k) =
              make_float4(acc[m][k], acc[m][k + 1], acc[m][k + 2], acc[m][k + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t col = tile0 + threadIdx.x + k * kThreads;
      if (col < D) {
#pragma unroll
        for (int m = 0; m < M; ++m) out[m * D + col] = acc[m][k];
      }
    }
  }
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    cohort_agg_kernel(const T* __restrict__ g, const float* __restrict__ w,
                      const float* __restrict__ lam, float* __restrict__ d,
                      float* __restrict__ partials, int C, int64_t D) {
  constexpr int V = Vec<T>::N;
  __shared__ float ws[2][kWChunk];
  __shared__ float warp_sums[kThreads / 32];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * (kThreads * V);
  float acc[2][V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[0][k] = acc[1][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kWChunk) {
    const int nc = min(kWChunk, C - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      const float wc = w[c0 + i];
      ws[0][i] = wc;
      ws[1][i] = wc - lam[c0 + i];
    }
    __syncthreads();
    accumulate_rows<T, 2, kAligned>(g, D, c0, nc, tile0, ws, acc);
  }

  // Columns past D hold zero accumulators and add nothing to the error.
  float sq = 0.f;
  if (kAligned) {
    const int64_t col = tile0 + static_cast<int64_t>(threadIdx.x) * V;
    if (col < D) {
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(d + col + k) =
            make_float4(acc[0][k], acc[0][k + 1], acc[0][k + 2], acc[0][k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t col = tile0 + threadIdx.x + k * kThreads;
      if (col < D) d[col] = acc[0][k];
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) sq = fmaf(acc[1][k], acc[1][k], sq);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += warp_sums[i];
    partials[blockIdx.x] = s;
  }
}

// One block: out[0] = sum of partials[0 .. n), in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
    sum_partials_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float warp_sums[kSumThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s += partials[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kSumThreads / 32; ++i) t += warp_sums[i];
    out[0] = t;
  }
}

int vec_width(int dtype) { return dtype == kBF16 ? Vec<__nv_bfloat16>::N : Vec<float>::N; }

int64_t n_tiles(int64_t D, int dtype) {
  const int64_t cols = static_cast<int64_t>(kThreads) * vec_width(dtype);
  return (D + cols - 1) / cols;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int M>
void launch_multi(const void* g, const float* w, float* out, int C, int64_t D,
                  bool aligned, int64_t blocks, cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  if (aligned)
    multi_agg_kernel<T, M, true><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(gt, w, out, C, D);
  else
    multi_agg_kernel<T, M, false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(gt, w, out, C, D);
}

template <typename T>
int dispatch_multi(const void* g, const float* w, float* out, int C, int64_t D, int M,
                   bool aligned, int64_t blocks, cudaStream_t s) {
  switch (M) {
    case 1: launch_multi<T, 1>(g, w, out, C, D, aligned, blocks, s); break;
    case 2: launch_multi<T, 2>(g, w, out, C, D, aligned, blocks, s); break;
    case 3: launch_multi<T, 3>(g, w, out, C, D, aligned, blocks, s); break;
    case 4: launch_multi<T, 4>(g, w, out, C, D, aligned, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch_cohort(const void* g, const float* w, const float* lam, float* d,
                   float* partials, int C, int64_t D, bool aligned, int64_t blocks,
                   cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  if (aligned)
    cohort_agg_kernel<T, true><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(gt, w, lam, d, partials, C, D);
  else
    cohort_agg_kernel<T, false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(gt, w, lam, d, partials, C, D);
}

}  // namespace

extern "C" {

// Number of column tiles (blocks) for D columns of the given dtype: the
// length of the partials buffer fwa_cohort_agg_and_error needs.
long long fwa_num_tiles(long long D, int dtype) { return n_tiles(D, dtype); }

// Largest M fwa_multi_weighted_agg takes.
int fwa_max_rows() { return 4; }

int fwa_multi_weighted_agg(const void* g, int dtype, const float* w, float* out, int C,
                           long long D, int M, void* stream) {
  if (C < 1 || D < 1 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = D % vec_width(dtype) == 0 && aligned16(g) && aligned16(out);
  const int64_t blocks = n_tiles(D, dtype);
  if (dtype == kF32) return dispatch_multi<float>(g, w, out, C, D, M, aligned, blocks, s);
  return dispatch_multi<__nv_bfloat16>(g, w, out, C, D, M, aligned, blocks, s);
}

int fwa_cohort_agg_and_error(const void* g, int dtype, const float* w, const float* lam,
                             float* d, float* partials, float* err, int C, long long D,
                             void* stream) {
  if (C < 1 || D < 1 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = D % vec_width(dtype) == 0 && aligned16(g) && aligned16(d);
  const int64_t blocks = n_tiles(D, dtype);
  if (dtype == kF32)
    launch_cohort<float>(g, w, lam, d, partials, C, D, aligned, blocks, s);
  else
    launch_cohort<__nv_bfloat16>(g, w, lam, d, partials, C, D, aligned, blocks, s);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  sum_partials_kernel<<<1, kSumThreads, 0, s>>>(partials, static_cast<int>(blocks), err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
