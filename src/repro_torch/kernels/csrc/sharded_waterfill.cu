// Per-shard water-filling level statistics, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sharded_waterfill.py:72
// waterfill_level_stats (pallas_call :99).  For shard-local scores a (M,) f32,
// in any order, with +inf entries inert, and L candidate levels with their
// floors (L,) f32:
//
//   n_below[k] = #{a < levels[k]}
//   n_floor[k] = #{a <= floors[k]}
//   mid_sum[k] = sum of a over floors[k] < a < levels[k]
//
// written as one (3, L) f32 array [n_below; n_floor; mid_sum].  The sharded
// K-Vib solve (src/repro_torch/core/solver.py) calls it once per ladder pass,
// five passes a solve, with L = 128 and M the shard's length.
//
// What bounds it on an H100: operations.  Every (score, level) pair costs two
// compares, two predicated integer adds and a predicated f32 add (about six
// operations), so (M = 10^6, L = 128) is ~7.7e8 operations against 4 MB of
// scores: ~190 operations per byte, far above the ~20 f32 operations per byte
// where the card's ALUs and not HBM become the limit.
//
// Design.  The TPU kernel walks one sequential grid over score chunks and
// carries a (3, L) accumulator in VMEM.  Here blocks run in parallel with
// nothing carried between them:
//   * block b stages scores [b * kChunk, (b + 1) * kChunk) in shared memory
//     with coalesced loads; the tail past M is masked by index and staged as
//     +inf, which no level counts;
//   * each thread owns levels k = threadIdx.x, threadIdx.x + kThreads, ...
//     (one level a thread at L = 128) and walks the whole chunk from shared
//     memory with 16-byte reads that every lane of a warp makes at the same
//     address (a broadcast, no bank conflicts), keeping int32 counts and an
//     f32 middle sum in registers;
//   * each block writes its (2L) counts and (L) sums as one row of the
//     partials, and a second pass sums every column in a fixed order (counts
//     as 64-bit integers, exact; sums through a fixed stride per thread, a
//     fixed warp-shuffle tree and a fixed order over warps), then converts
//     the counts to f32.  No float atomics: repeated launches are bitwise
//     equal.  With a single block (M <= kChunk) the first pass writes the
//     result itself and the second pass is skipped.
// The kernel does not use the order of the scores (the solve passes them
// sorted, the tests do not); a sorted-input search is left for a later PR.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the given
// stream, allocate nothing, and return cudaGetLastError() (0 = ok).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads per block of the first pass
constexpr int kChunk = 2048;      // scores per block of the first pass
constexpr int kSumThreads = 256;  // threads per block of the second pass

__device__ __forceinline__ void visit(float a, float lv, float fl, int& nb, int& nf,
                                      float& mid) {
  const bool below = a < lv;
  const bool at_floor = a <= fl;
  nb += below;
  nf += at_floor;
  if (below && !at_floor) mid += a;
}

// Block b: the statistics of its chunk for all L levels.  kFinal (the grid is
// one block): write the (3, L) f32 result; otherwise row b of the partials,
// cnt_part (n_blocks, 2L) int32 and mid_part (n_blocks, L) f32.
template <bool kFinal>
__global__ void __launch_bounds__(kThreads)
    level_stats_kernel(const float* __restrict__ scores, int64_t M,
                       const float* __restrict__ levels, const float* __restrict__ floors,
                       int L, int* __restrict__ cnt_part, float* __restrict__ mid_part,
                       float* __restrict__ out) {
  __shared__ __align__(16) float s[kChunk];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int n = static_cast<int>(min(static_cast<int64_t>(kChunk), M - base));
  for (int i = threadIdx.x; i < kChunk; i += kThreads) s[i] = i < n ? scores[base + i] : INFINITY;
  __syncthreads();

  const int n4 = (n + 3) >> 2;  // staged entries past n are +inf: inert
  const float4* s4 = reinterpret_cast<const float4*>(s);
  for (int k = threadIdx.x; k < L; k += kThreads) {
    const float lv = levels[k];
    const float fl = floors[k];
    int nb = 0;
    int nf = 0;
    float mid = 0.f;
#pragma unroll 4
    for (int i = 0; i < n4; ++i) {
      const float4 v = s4[i];
      visit(v.x, lv, fl, nb, nf, mid);
      visit(v.y, lv, fl, nb, nf, mid);
      visit(v.z, lv, fl, nb, nf, mid);
      visit(v.w, lv, fl, nb, nf, mid);
    }
    if (kFinal) {
      out[k] = static_cast<float>(nb);
      out[L + k] = static_cast<float>(nf);
      out[2 * L + k] = mid;
    } else {
      int* row = cnt_part + static_cast<int64_t>(blockIdx.x) * 2 * L;
      row[k] = nb;
      row[L + k] = nf;
      mid_part[static_cast<int64_t>(blockIdx.x) * L + k] = mid;
    }
  }
}

// Block c < 2L: out[c] = the integer sum of cnt_part[:, c], as f32.  Block
// 2L + k: out[2L + k] = the sum of mid_part[:, k] in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
    sum_partials_kernel(const int* __restrict__ cnt_part, const float* __restrict__ mid_part,
                        int64_t n_rows, int L, float* __restrict__ out) {
  __shared__ long long warp_counts[kSumThreads / 32];
  __shared__ float warp_sums[kSumThreads / 32];
  const int c = blockIdx.x;  // the same for the whole block: the branch is uniform
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (c < 2 * L) {
    long long s = 0;
    for (int64_t t = threadIdx.x; t < n_rows; t += kSumThreads) s += cnt_part[t * 2 * L + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) warp_counts[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      long long u = 0;
#pragma unroll
      for (int i = 0; i < kSumThreads / 32; ++i) u += warp_counts[i];
      out[c] = static_cast<float>(u);
    }
  } else {
    const int k = c - 2 * L;
    float s = 0.f;
    for (int64_t t = threadIdx.x; t < n_rows; t += kSumThreads) s += mid_part[t * L + k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) warp_sums[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float u = 0.f;
#pragma unroll
      for (int i = 0; i < kSumThreads / 32; ++i) u += warp_sums[i];
      out[c] = u;
    }
  }
}

int64_t num_blocks(int64_t M) { return (M + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// Blocks of the first pass for M scores: the row count of the partials.
long long wf_num_blocks(long long M) { return num_blocks(M); }

// scores (M,) f32, levels / floors (L,) f32 -> out (3, L) f32.  cnt_part
// (n_blocks, 2L) int32 and mid_part (n_blocks, L) f32 are scratch; with one
// block they are not touched and may be null.
int wf_level_stats(const float* scores, long long M, const float* levels, const float* floors,
                   int L, int* cnt_part, float* mid_part, float* out, void* stream) {
  if (M < 1 || M > INT32_MAX || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = num_blocks(M);
  if (blocks == 1) {
    level_stats_kernel<true><<<1, kThreads, 0, s>>>(scores, M, levels, floors, L, nullptr,
                                                     nullptr, out);
    return static_cast<int>(cudaGetLastError());
  }
  level_stats_kernel<false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      scores, M, levels, floors, L, cnt_part, mid_part, nullptr);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  sum_partials_kernel<<<3 * L, kSumThreads, 0, s>>>(cnt_part, mid_part, blocks, L, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
