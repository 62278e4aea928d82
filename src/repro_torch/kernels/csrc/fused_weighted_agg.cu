// Fused weighted aggregation of stacked client deltas, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/fused_weighted_agg.py:
//
//   fwa_weighted_agg          <- fused_weighted_agg (:134, pallas_call :146)
//       d (D,) f32 = sum_c w_c g_c and sq (C,) f32 = ||g_c||^2, one read of g.
//   fwa_multi_weighted_agg    <- fused_multi_weighted_agg (:174, pallas_call :189)
//       out (M, D) f32 = w (M, C) f32 x g (C, D) f32|bf16, one read of g.
//       Oracle mode runs it with M = 2 (estimate row, estimate - target row).
//   fwa_cohort_agg_and_error  <- fused_cohort_agg_and_error (:221, pallas_call :248)
//       d (D,) f32 = sum_c w_c g_c and err () f32 = ||sum_c (w_c - lam_c) g_c||^2;
//       the error row is squared and reduced on chip and never written out.
//   fwa_dequant_cohort_agg    <- fused_dequant_cohort_agg (:296, pallas_call :328)
//       q (C, D_pad) int8|fp8 e4m3 codes with (C, nb) f32 block scales, widened
//       in registers to g = float(q) * scale; d (D_pad,), err () and sq (C,) as
//       above, one read of q.
//
// What bounds them on an H100: memory.  Each element of g is read once and
// used for 2M flops, about 1 flop per byte for f32 (the card needs ~20 f32
// flops per byte before the ALUs, not HBM at 3.35 TB/s, are the limit), so
// the time is the bytes of g over the memory rate.  The compressed kernel is
// the exception to watch: one byte per element carries a widening, a scale
// multiply and three FMAs, about 8 operations per byte, and Hopper converts
// an int8 or fp8 value to f32 at a quarter of the FMA rate or less, so at
// full HBM rate the conversions come close to the issue limit.  It uses the
// plain conversions (I2F; the paired fp8 -> half2 cvt, then half -> f32);
// faster widening (byte-permute tricks) is left for when a measurement shows
// the conversions binding.
//
// Design.  The TPU kernels walk a sequential grid over D and carry their
// sums (the squared error, the (C,) norms) in VMEM scratch from step to step.
// Hopper's blocks run in parallel and in no order, so here:
//   * each block owns one tile of kThreads * V columns (V = 16 bytes / the
//     element size: 4 f32, 8 bf16, 16 int8 or fp8) and loops over all C rows,
//     so every element of g is loaded exactly once, by one thread;
//   * a thread keeps its accumulators in registers in f32 and reads g with
//     16-byte vector loads when every row starts 16-byte aligned (D % V == 0,
//     an aligned base and, for the compressed kernel, a scale block that is a
//     multiple of V, so a vector shares one scale); otherwise it reads V
//     scalars spaced kThreads apart (still coalesced across the warp) and
//     masks the ragged edge, so any D and any scale block are valid;
//   * the (M, C) weights are staged through shared memory kWChunk columns at
//     a time, so C is not bounded by shared memory;
//   * no float atomics anywhere: a cross-block sum (kernel 2's error, kernel
//     3's and 4's per-row norms and kernel 4's error) is written as one
//     partial per block into an (n_tiles, n_sums) buffer, and a second pass
//     sums each column in a fixed order, so repeated runs are bitwise equal.
//     A row's norm partial within a block is a warp-shuffle sum per row, then
//     a fixed-order sum over the block's warps through shared memory.
// Not yet used: TMA, cp.async pipelining, wgmma.  The loads of the C rows
// are independent, so the unrolled row loop keeps several in flight.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError() (0 = ok).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kWChunk = 256;   // weight columns staged in shared memory per pass
constexpr int kSumThreads = 256;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

// A float8_e4m3fn code, moved as its raw byte.
struct Fp8 {
  __nv_fp8_storage_t x;
};

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
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
};
template <>
struct Vec<Fp8> {
  static constexpr int N = 16;
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

__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const char4* b = reinterpret_cast<const char4*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[4 * k] = static_cast<float>(b[k].x);
    out[4 * k + 1] = static_cast<float>(b[k].y);
    out[4 * k + 2] = static_cast<float>(b[k].z);
    out[4 * k + 3] = static_cast<float>(b[k].w);
  }
}

// e4m3 -> half is exact (half covers e4m3's range and precision), and so is
// half -> f32.
__device__ __forceinline__ void load_vec(const Fp8* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_fp8x2_storage_t* h = reinterpret_cast<const __nv_fp8x2_storage_t*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(h[k], __NV_E4M3)));
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(Fp8 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.x, __NV_E4M3)));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;  // the full sum in lane 0
}

// Block-wide sum of one value per thread; the result is valid in thread 0.
// `scratch` holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float s, float* scratch) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += scratch[i];
  }
  return t;
}

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
  sq = block_sum(sq, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = sq;
}

// Kernels 3 and 4: d = sum_c w_c g_c, the per-row squared norms ||g_c||^2
// and, with kErr, the error row's squared norm, in one read of g.  With
// kScaled, g is (C, D) codes and g[c, col] = float(code) * scales[c, col / sb].
// Block b writes its partial sums to partials[b * n_sums + j]: j < C the norm
// of row j over the block's columns, j = C (with kErr) the error.
template <typename T, bool kScaled, bool kErr, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    agg_norms_kernel(const T* __restrict__ g, const float* __restrict__ scales, int64_t nb,
                     int64_t sb, const float* __restrict__ w, const float* __restrict__ lam,
                     float* __restrict__ d, float* __restrict__ partials, int C, int64_t D) {
  constexpr int V = Vec<T>::N;
  constexpr int kRows = kErr ? 2 : 1;
  constexpr int kWarps = kThreads / 32;
  __shared__ float ws[kRows][kWChunk];
  __shared__ float row_sq[kWarps][kWChunk];
  __shared__ float warp_sums[kWarps];
  const int n_sums = C + (kErr ? 1 : 0);
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * (kThreads * V);
  // Aligned: the thread's columns are col0 + k.  Scalar: col0 + k * kThreads.
  const int64_t col0 = tile0 + (kAligned ? static_cast<int64_t>(threadIdx.x) * V : threadIdx.x);
  // The scale block of each of the thread's columns, the same in every row
  // (clamped into range for masked columns, whose values are zero anyway).
  int64_t blk[kAligned ? 1 : V];
  if (kScaled) {
    if (kAligned) {
      blk[0] = (col0 < D ? col0 : D - 1) / sb;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t col = col0 + k * kThreads;
        blk[k] = (col < D ? col : D - 1) / sb;
      }
    }
  }
  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[r][k] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += kWChunk) {
    const int nc = min(kWChunk, C - c0);
    __syncthreads();  // the previous chunk's weights and row sums are no longer read
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      const float wc = w[c0 + i];
      ws[0][i] = wc;
      if (kErr) ws[kRows - 1][i] = wc - lam[c0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const int64_t row = c0 + c;
      const T* p = g + row * D;
      float x[V];
      if (kAligned) {
        if (col0 < D) {
          load_vec(p + col0, x);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] = 0.f;
        }
        if (kScaled) {
          const float s = scales[row * nb + blk[0]];
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] *= s;
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int64_t col = col0 + k * kThreads;
          x[k] = col < D ? to_f32(p[col]) : 0.f;
          if (kScaled) x[k] *= scales[row * nb + blk[kAligned ? 0 : k]];
        }
      }
      float sq = 0.f;
      const float w0 = ws[0][c];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc[0][k] = fmaf(w0, x[k], acc[0][k]);
        sq = fmaf(x[k], x[k], sq);
      }
      if (kErr) {
        const float w1 = ws[kRows - 1][c];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[kRows - 1][k] = fmaf(w1, x[k], acc[kRows - 1][k]);
      }
      sq = warp_sum(sq);
      if ((threadIdx.x & 31) == 0) row_sq[threadIdx.x >> 5][c] = sq;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) s += row_sq[j][i];
      partials[static_cast<int64_t>(blockIdx.x) * n_sums + c0 + i] = s;
    }
  }

  if (kAligned) {
    if (col0 < D) {
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(d + col0 + k) =
            make_float4(acc[0][k], acc[0][k + 1], acc[0][k + 2], acc[0][k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t col = col0 + k * kThreads;
      if (col < D) d[col] = acc[0][k];
    }
  }
  if (kErr) {
    // Columns past D hold zero accumulators and add nothing to the error.
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) e = fmaf(acc[kRows - 1][k], acc[kRows - 1][k], e);
    e = block_sum(e, warp_sums);
    if (threadIdx.x == 0) partials[static_cast<int64_t>(blockIdx.x) * n_sums + C] = e;
  }
}

// Block b: out[b] = sum over t < n_rows of p[t * n_cols + b], in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
    sum_columns_kernel(const float* __restrict__ p, int64_t n_rows, int n_cols,
                       float* __restrict__ out) {
  __shared__ float warp_sums[kSumThreads / 32];
  float s = 0.f;
  for (int64_t t = threadIdx.x; t < n_rows; t += kSumThreads) s += p[t * n_cols + blockIdx.x];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < kSumThreads / 32; ++i) u += warp_sums[i];
    out[blockIdx.x] = u;
  }
}

int vec_width(int dtype) {
  switch (dtype) {
    case kBF16: return Vec<__nv_bfloat16>::N;
    case kI8: return Vec<int8_t>::N;
    case kFP8: return Vec<Fp8>::N;
    default: return Vec<float>::N;
  }
}

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

template <typename T, bool kScaled, bool kErr>
void launch_agg_norms(const void* g, const float* scales, int64_t nb, int64_t sb,
                      const float* w, const float* lam, float* d, float* partials, int C,
                      int64_t D, bool aligned, int64_t blocks, cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (aligned)
    agg_norms_kernel<T, kScaled, kErr, true><<<grid, kThreads, 0, s>>>(gt, scales, nb, sb, w, lam, d, partials, C, D);
  else
    agg_norms_kernel<T, kScaled, kErr, false><<<grid, kThreads, 0, s>>>(gt, scales, nb, sb, w, lam, d, partials, C, D);
}

// The second pass: out[j] = sum over the n_rows tiles of partials[:, j].
int sum_columns(const float* partials, int64_t n_rows, int n_cols, float* out, cudaStream_t s) {
  int rc = static_cast<int>(cudaGetLastError());  // the first pass's launch
  if (rc != 0) return rc;
  sum_columns_kernel<<<n_cols, kSumThreads, 0, s>>>(partials, n_rows, n_cols, out);
  return static_cast<int>(cudaGetLastError());
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
  return sum_columns(partials, blocks, 1, err, s);
}

// partials: fwa_num_tiles(D, dtype) * C floats of scratch.
int fwa_weighted_agg(const void* g, int dtype, const float* w, float* d, float* partials,
                     float* sq, int C, long long D, void* stream) {
  if (C < 1 || D < 1 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = D % vec_width(dtype) == 0 && aligned16(g) && aligned16(d);
  const int64_t blocks = n_tiles(D, dtype);
  if (dtype == kF32)
    launch_agg_norms<float, false, false>(g, nullptr, 1, 1, w, nullptr, d, partials, C, D, aligned, blocks, s);
  else
    launch_agg_norms<__nv_bfloat16, false, false>(g, nullptr, 1, 1, w, nullptr, d, partials, C, D, aligned, blocks, s);
  return sum_columns(partials, blocks, C, sq, s);
}

// q: (C, D) int8 or fp8 codes; scales: (C, nb) f32 with D % nb == 0.
// partials: fwa_num_tiles(D, dtype) * (C + 1) floats of scratch.
// sums: C + 1 floats, the C squared norms, then the error.
int fwa_dequant_cohort_agg(const void* q, int dtype, const float* scales, int nb,
                           const float* w, const float* lam, float* d, float* partials,
                           float* sums, int C, long long D, void* stream) {
  if (C < 1 || D < 1 || nb < 1 || D % nb != 0 || (dtype != kI8 && dtype != kFP8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t sb = D / nb;
  const int V = vec_width(dtype);
  const bool aligned = D % V == 0 && sb % V == 0 && aligned16(q) && aligned16(d);
  const int64_t blocks = n_tiles(D, dtype);
  if (dtype == kI8)
    launch_agg_norms<int8_t, true, true>(q, scales, nb, sb, w, lam, d, partials, C, D, aligned, blocks, s);
  else
    launch_agg_norms<Fp8, true, true>(q, scales, nb, sb, w, lam, d, partials, C, D, aligned, blocks, s);
  return sum_columns(partials, blocks, C + 1, sums, s);
}

}  // extern "C"
