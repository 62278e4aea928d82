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
//   * every element of g is loaded exactly once, by one thread, which keeps
//     its accumulators in registers in f32 and reads g with 16-byte vector
//     loads when every row starts 16-byte aligned (V = 16 bytes / the element
//     size: 4 f32, 8 bf16, 16 int8 or fp8); otherwise with V scalar loads
//     spaced a warp (kernels 1-2) or kThreads (kernels 3-4) apart, still
//     coalesced across the warp, masking the ragged edge, so any D and any
//     scale block are valid;
//   * kernels 1 and 2 split C inside the block: a tile is one warp's width
//     of vectors (32 * V columns) and a block up to 16 warps; each warp
//     walks about 8 of the C rows of the tile into its own accumulators,
//     and the warps' sums are added through shared memory in warp order.
//     A warp copies its rows global -> shared with cp.async (vectors, a
//     batch of 8 rows) or loads them into registers (scalars, 32 values a
//     lane), the whole batch before it multiplies any row.
//     Tiles enough to fill the card (huge D), or C <= 16 rows with a
//     block of 4 warps for every SM (tiny_lm's deployable C = 10 in f32),
//     go one to a warp, each warp walking all C rows; otherwise (the
//     oracle's C = 50 over tiny_lm's 896 tiles) a block splits C.
//     Kernel 1 launches a block for every tile (4 tiles where the warps
//     own theirs); kernel 2 at most the blocks resident at once, each
//     walking its share of the tiles with the next batch in flight.  The
//     logreg shape (C = 100, D = 610) is 5 tiles of 13 warps, one batch a
//     warp (f32); kernel 1 needs no pass across blocks;
//   * kernels 3 and 4 give each block one tile of kThreads * V columns and
//     loop over all C rows, staging the weights through shared memory
//     kWChunk columns at a time;
//   * no float atomics anywhere: a cross-block sum is written as one partial
//     per block and summed in a fixed order, so repeated runs are bitwise
//     equal.  Kernel 2 does it in its one launch: the last block to finish,
//     found by an integer atomic ticket after a __threadfence, sums the
//     partials in index order.  Kernels 3 and 4 (per-row norms, kernel 4's
//     error) write an (n_tiles, n_sums) buffer that a second pass sums
//     column by column.  A row's norm partial within a block is a warp-
//     shuffle sum per row, then a fixed-order sum over the block's warps
//     through shared memory.
// Not used: TMA, wgmma; cp.async only in kernels 1 and 2.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError() (0 = ok).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;  // threads per block of kernels 3 and 4
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

// Sum over the block of one value per thread, in a fixed order (lanes by
// shuffle, then warps in order); valid in thread 0.  `scratch` holds one
// float a warp; the caller syncs before reusing it.
__device__ __forceinline__ float block_sum(float s, float* scratch) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) t += scratch[i];
  }
  return t;
}

// Kernels 1 and 2: C split over the warps of a block.  A tile is 32 * V
// columns (one warp's width of 16-byte vectors); warp w of a block walks
// rows [w * rpw, (w + 1) * rpw) of each of its block's tiles, and the
// warps' sums of a tile are added through shared memory in warp order.
// Block b takes tiles b, b + gridDim.x, ...  At huge D (tiles enough to
// fill the card), and at C <= 2 kRowBatch where that leaves a block for
// every SM, the warps own their tiles instead: each walks all C rows of
// tiles of its own, every row in flight at small C, and writes its sums,
// with no shared memory between warps.
//
// A lane's V columns of a tile are V / L chunks of L contiguous elements,
// chunk j at tile0 + j * 32 * L + lane * L: L = V (one 16-byte vector at
// tile0 + lane * V) where D is a multiple of V and g 16-byte aligned, else
// L = 1 (V scalars 32 apart, coalesced across the warp; 8-byte loads where
// D is even were no faster).  A warp's unit of work is a batch of rows of
// a tile.  With vectors (kRowBatch rows) a warp copies a batch global ->
// shared with cp.async, each lane into its own 16-byte slot a row, and
// waits for the whole batch before it multiplies any row: issued as plain
// loads, ptxas put each row's FMAs right behind its load, so a warp waited
// one memory latency a row.  With two stages a warp's next unit is in
// flight while it multiplies the current one.  Scalars load into
// registers, 32 values a lane a unit (8 rows f32, 4 bf16), the next unit's
// while the current one is multiplied, each unit's loads in one block of
// code: a bf16 load and its conversion in a block of their own (a branch
// a row) waited one memory latency a row.  PERF.md §6 has the trials.
constexpr int kMaxAggWarps = 16;
constexpr int kOwnWarps = 4;  // warps a block where each warp owns its tiles
constexpr int kRowsPerWarp = 8;  // the rows a warp walks when C allows
constexpr int kRowBatch = 8;
constexpr int kSlotBytes = 32 * 16;  // one row of a warp's batch in shared memory
constexpr int kSumBatch = 16;  // partials a thread of kernel 2's last block loads at once

// How a launch of kernel 1 or 2 splits its work (the host's plan).
struct AggPlan {
  int rpw;         // rows a warp walks
  int batch_rows;  // rows a unit of work through shared memory (<= kRowBatch)
  int stages;      // shared-memory stages a warp (1 or 2; 0 without cp.async)
  int own;         // 1: each warp walks all C rows of tiles of its own
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest N groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows c0 .. min(c0 + kRowBatch, r1) - 1 of the tile at tile0 into
// `stage`, row u to the lane's slot at u * kSlotBytes + lane * 16; a lane
// past D copies the row's last vector, which staged_values ignores.
template <typename T>
__device__ __forceinline__ void issue_batch(const T* __restrict__ g, int64_t D, int c0, int r1,
                                            int64_t tile0, int lane, unsigned char* stage) {
  constexpr int V = Vec<T>::N;
  const int64_t col = tile0 + lane * V;
#pragma unroll
  for (int u = 0; u < kRowBatch; ++u) {
    if (c0 + u < r1)
      cp_async16(smem_u32(stage + u * kSlotBytes + lane * 16),
                 g + static_cast<int64_t>(c0 + u) * D + (col < D ? col : D - V));
  }
}

// The batch's rows as f32 from the lane's slots of `stage`, x[u][k]
// (zero past r1 and past D).
template <typename T>
__device__ __forceinline__ void staged_values(int64_t D, int c0, int r1, int64_t tile0, int lane,
                                              const unsigned char* stage,
                                              float (&x)[kRowBatch][Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  const bool in = tile0 + lane * V < D;
#pragma unroll
  for (int u = 0; u < kRowBatch; ++u) {
    if (in && c0 + u < r1) {
      load_vec(reinterpret_cast<const T*>(stage + u * kSlotBytes + lane * 16), x[u]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) x[u][k] = 0.f;
    }
  }
}

// Rows c0 .. c0 + R - 1 of the tile at tile0 as f32, x[u][j] = g[c0 + u,
// tile0 + j * 32 + lane], loaded from global memory (zero past r1 and past
// D: those load row r1 - 1 or column D - 1, then read as zero).  Each
// branch loads the whole unit in one block of code, so that ptxas issues
// every load before the first conversion waits on one.
template <typename T, int R>
__device__ __forceinline__ void scalar_values(const T* __restrict__ g, int64_t D, int c0, int r1,
                                              int64_t tile0, int lane,
                                              float (&x)[R][Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  if (tile0 + 32 * V <= D) {  // constant offsets from one address a row
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const T* p = g + static_cast<int64_t>(min(c0 + u, r1 - 1)) * D + tile0 + lane;
#pragma unroll
      for (int j = 0; j < V; ++j) x[u][j] = to_f32(p[j * 32]);
    }
  } else {  // the last tile
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const T* p = g + static_cast<int64_t>(min(c0 + u, r1 - 1)) * D;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int64_t col = tile0 + j * 32 + lane;
        x[u][j] = to_f32(p[col < D ? col : D - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (tile0 + j * 32 + lane >= D) x[u][j] = 0.f;
      }
    }
  }
  if (c0 + R > r1) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (c0 + u >= r1) x[u][j] = 0.f;
      }
    }
  }
}

// Walk the block's tiles (with plan.own, the warp's own): acc[m][j * L + e]
// = sum over the warp's rows c of wt_m(c) * g[c, tile0 + j * 32 * L +
// lane * L + e], in row order, then on_tile(tile0, acc), which every warp
// of the block reaches together unless the warps own their tiles.
// Kernel 1's weights are w[m * C + c]; kernel 2's (kCohort, M = 2) w[c]
// and w[c] - lam[c].  `stages` is the warp's plan.stages stages.
template <typename T, int M, int L, bool kCohort, typename OnTile>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ g, const float* __restrict__ w,
                                           const float* __restrict__ lam, int C, int64_t D,
                                           AggPlan plan, unsigned char* stages, OnTile on_tile) {
  constexpr int V = Vec<T>::N;
  constexpr int kTile = 32 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int r0 = plan.own ? 0 : warp * plan.rpw, r1 = min(C, r0 + plan.rpw);
  // Rows a unit: kRowBatch through shared memory; with scalars 32 values a
  // lane, since a lane holds two units.
  constexpr int R = L == V ? kRowBatch : 32 / V;
  const int n_batches = (plan.rpw + R - 1) / R;  // the same in every warp
  const int64_t n_tiles = (D + kTile - 1) / kTile;
  // The warp's tiles: first, first + stride, ... (the block's, or its own);
  // its units tile by tile, batch b of a tile its rows r0 + b * R ...
  const int64_t stride = plan.own ? static_cast<int64_t>(gridDim.x) * n_warps : gridDim.x;
  int64_t tile = plan.own ? static_cast<int64_t>(blockIdx.x) * n_warps + warp : blockIdx.x;
  int b = 0;
  int64_t next_tile = n_batches > 1 ? tile : tile + stride;  // the unit after (tile, b)
  int next_b = n_batches > 1 ? 1 : 0;
  const int stage_bytes = plan.batch_rows * kSlotBytes;
  int s = 0;  // the current unit's stage
  float acc[M][V];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[m][k] = 0.f;
  }
  float x[R][V];  // the current unit's values
  if constexpr (L == V) {
    if (tile < n_tiles) issue_batch<T>(g, D, r0, r1, tile * kTile, lane, stages);
    cp_async_commit();
  } else {
    if (tile < n_tiles) scalar_values<T, R>(g, D, r0, r1, tile * kTile, lane, x);
  }
  while (tile < n_tiles) {
    const int64_t tile0 = tile * kTile;
    const int c0 = r0 + b * R;
    float x_next[R][V];  // scalars: the next unit's, in flight while x is multiplied
    if constexpr (L == V) {
      if (plan.stages == 2) {  // the next unit in flight while this one is multiplied
        if (next_tile < n_tiles)
          issue_batch<T>(g, D, r0 + next_b * R, r1, next_tile * kTile, lane,
                         stages + (s ^ 1) * stage_bytes);
        cp_async_commit();  // possibly empty: one group an iteration
        cp_async_wait<1>();
      } else {  // one stage: the warp's only unit
        cp_async_wait<0>();
      }
      staged_values<T>(D, c0, r1, tile0, lane, stages + s * stage_bytes, x);
    } else {
      if (next_tile < n_tiles)
        scalar_values<T, R>(g, D, r0 + next_b * R, r1, next_tile * kTile, lane, x_next);
    }
#pragma unroll
    for (int u2 = 0; u2 < R; ++u2) {
      const int c = c0 + u2;
      const bool row = c < r1;
      float wt[M];
      if (kCohort) {
        wt[0] = row ? w[c] : 0.f;
        wt[M - 1] = row ? w[c] - lam[c] : 0.f;
      } else {
#pragma unroll
        for (int m = 0; m < M; ++m) wt[m] = row ? w[static_cast<int64_t>(m) * C + c] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[m][k] = fmaf(wt[m], x[u2][k], acc[m][k]);
      }
    }
    if constexpr (L != V) {
#pragma unroll
      for (int u = 0; u < R; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) x[u][k] = x_next[u][k];
      }
    }
    if (b == n_batches - 1) {
      on_tile(tile0, acc);
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[m][k] = 0.f;
      }
    }
    tile = next_tile;
    b = next_b;
    if (++next_b == n_batches) {
      next_b = 0;
      next_tile += stride;
    }
    s ^= plan.stages == 2;
  }
}

// Column j * 32 * L + lane * L + e of the tile: the thread's acc[j * L + e].
template <int V, int L>
__device__ __forceinline__ int tile_col(int k, int lane) {
  return (k / L) * 32 * L + lane * L + k % L;
}

// The warps' sums of one tile row, each warp's laid out by column within
// the tile in `red` (n_warps x 32 V floats of shared memory).
template <int V, int L>
__device__ __forceinline__ void stage_warp_sums(const float (&acc)[V], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < V; ++k) red[warp * 32 * V + tile_col<V, L>(k, lane)] = acc[k];
}

// Column i of the tile summed over the block's warps, in warp order.
template <int V>
__device__ __forceinline__ float sum_warps(const float* red, int i) {
  float s = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w * 32 * V + i];
  return s;
}

// Dynamic shared memory of kernels 1 and 2: each warp's stages, then the
// tile sums of one row (none where the warps own their tiles).
template <typename T>
constexpr size_t agg_smem_bytes(int n_warps, AggPlan plan) {
  return static_cast<size_t>(n_warps) * plan.stages * plan.batch_rows * kSlotBytes +
         (plan.own ? 0 : static_cast<size_t>(n_warps) * 32 * Vec<T>::N * sizeof(float));
}

template <typename T, int M, int L>
__global__ void __launch_bounds__(kMaxAggWarps * 32)
    multi_agg_kernel(const T* __restrict__ g, const float* __restrict__ w,
                     float* __restrict__ out, int C, int64_t D, AggPlan plan) {
  constexpr int V = Vec<T>::N;
  constexpr int kTile = 32 * V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int stage_bytes = plan.stages * plan.batch_rows * kSlotBytes;
  float* red = reinterpret_cast<float*>(smem + n_warps * stage_bytes);
  walk_tiles<T, M, L, false>(
      g, w, nullptr, C, D, plan, smem + (threadIdx.x >> 5) * stage_bytes,
      [&](int64_t tile0, const float (&acc)[M][V]) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if (plan.own) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const int64_t col = tile0 + tile_col<V, L>(k, lane);
              if (col < D) out[m * D + col] = acc[m][k];
            }
            continue;
          }
          __syncthreads();  // the previous row's (or tile's) sums are read
          stage_warp_sums<V, L>(acc[m], red);
          __syncthreads();
          for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
            if (tile0 + i < D) out[m * D + tile0 + i] = sum_warps<V>(red, i);
          }
        }
      });
}

// Kernel 2 in one launch: each block writes d over its tiles and its
// partial of the error row's squared norm to partials[blockIdx.x]; the
// last block to finish (an integer ticket on *counter after a
// __threadfence) sums all partials in index order into *err and sets
// *counter back to 0 for the next launch on the stream.
template <typename T, int L>
__global__ void __launch_bounds__(kMaxAggWarps * 32)
    cohort_agg_kernel(const T* __restrict__ g, const float* __restrict__ w,
                      const float* __restrict__ lam, float* __restrict__ d,
                      float* __restrict__ partials, unsigned int* __restrict__ counter,
                      float* __restrict__ err, int C, int64_t D, AggPlan plan) {
  constexpr int V = Vec<T>::N;
  constexpr int kTile = 32 * V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[kMaxAggWarps];
  __shared__ bool last;
  const int n_warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int stage_bytes = plan.stages * plan.batch_rows * kSlotBytes;
  float* red = reinterpret_cast<float*>(smem + n_warps * stage_bytes);
  float sq = 0.f;  // columns past D sum to zero and add nothing
  walk_tiles<T, 2, L, true>(
      g, w, lam, C, D, plan, smem + (threadIdx.x >> 5) * stage_bytes,
      [&](int64_t tile0, const float (&acc)[2][V]) {
        if (plan.own) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int64_t col = tile0 + tile_col<V, L>(k, lane);
            if (col < D) d[col] = acc[0][k];
            sq = fmaf(acc[1][k], acc[1][k], sq);
          }
          return;
        }
        __syncthreads();  // the previous tile's sums are read
        stage_warp_sums<V, L>(acc[0], red);
        __syncthreads();
        for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
          if (tile0 + i < D) d[tile0 + i] = sum_warps<V>(red, i);
        }
        __syncthreads();
        stage_warp_sums<V, L>(acc[1], red);
        __syncthreads();
        for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
          const float e = sum_warps<V>(red, i);
          sq = fmaf(e, e, sq);
        }
      });
  sq = block_sum(sq, scratch);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = sq;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // Thread t adds partials t, t + blockDim.x, ... in that order, kSumBatch
  // loads in flight at a time, from L2, where the other blocks' are.
  const int n = gridDim.x, bd = blockDim.x;
  float t = 0.f;
  for (int i0 = threadIdx.x; i0 < n; i0 += kSumBatch * bd) {
    float p[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) p[u] = __ldcg(partials + min(i0 + u * bd, n - 1));
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) t += i0 + u * bd < n ? p[u] : 0.f;
  }
  t = block_sum(t, scratch);
  if (threadIdx.x == 0) {
    *err = t;
    *counter = 0u;
  }
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

// Blocks of one kernel resident on the current device at once, for a
// block size and dynamic shared memory (asked once each; the kernel is
// first allowed the largest shared memory a plan takes).
template <auto Kernel, typename T>
int resident_blocks(int n_warps, AggPlan plan) {
  static int cache[kMaxAggWarps + 1][3][2][64] = {};  // by warps, stages, own and device
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = cache[n_warps][plan.stages][plan.own][dev & 63];
  if (n == 0) {
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(agg_smem_bytes<T>(kMaxAggWarps, {0, kRowBatch, 2, 0})));
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, Kernel, n_warps * 32, agg_smem_bytes<T>(n_warps, plan));
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n = std::max(1, per_sm * sms);
  }
  return n;
}

// A launch of kernel 1 or 2 (Kernel, element type T, chunk width L) for C
// rows of D columns.  Tiles enough to fill the card (huge D), or at most
// two batches of rows with a block for every SM, take blocks of kOwnWarps
// warps, each warp walking all C rows of tiles of its own; otherwise a
// block's warps split C, about kRowsPerWarp rows a warp, at
// least min_warps and at most kMaxAggWarps warps, no warp without rows.
// Every tile gets a warp (or a block), or, with `bounded`, the grid is at
// most the blocks resident at once (kernel 2, whose last block sums one
// partial a block).  Vectors take two stages where a warp has more than
// one unit of work.
struct Launch {
  AggPlan plan;
  int n_warps;
  int64_t grid;
  size_t smem;
};

template <auto Kernel, typename T, int L>
Launch agg_launch(int C, int64_t D, int min_warps, bool bounded) {
  const int64_t n_tiles = (D + 32 * Vec<T>::N - 1) / (32 * Vec<T>::N);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Launch l;
  l.plan.own = n_tiles >= 32 * static_cast<int64_t>(sms) ||
               (C <= 2 * kRowBatch && n_tiles >= kOwnWarps * static_cast<int64_t>(sms));
  if (l.plan.own) {
    l.n_warps = kOwnWarps;
    l.plan.rpw = C;
    l.grid = (n_tiles + kOwnWarps - 1) / kOwnWarps;
  } else {
    const int warps = std::min(
        kMaxAggWarps, std::max({1, std::min(C, min_warps), (C + kRowsPerWarp - 1) / kRowsPerWarp}));
    l.plan.rpw = (C + warps - 1) / warps;
    l.n_warps = (C + l.plan.rpw - 1) / l.plan.rpw;
    l.grid = n_tiles;
  }
  l.plan.batch_rows = std::min(l.plan.rpw, kRowBatch);
  const bool async = L == Vec<T>::N;
  l.plan.stages = async ? (l.plan.rpw > kRowBatch ? 2 : 1) : 0;
  if (bounded && l.grid > resident_blocks<Kernel, T>(l.n_warps, l.plan)) {
    if (async) l.plan.stages = 2;
    l.grid = resident_blocks<Kernel, T>(l.n_warps, l.plan);
  }
  l.smem = agg_smem_bytes<T>(l.n_warps, l.plan);
  if (l.smem > 48 * 1024) resident_blocks<Kernel, T>(l.n_warps, l.plan);  // allows it
  return l;
}

// Whether every row of g starts 16-byte aligned (L = V) or not (L = 1).
template <typename T>
bool vector_rows(const void* g, int64_t D) {
  return D % Vec<T>::N == 0 && aligned16(g);
}

template <typename T, int M, int L>
void launch_multi(const void* g, const float* w, float* out, int C, int64_t D, cudaStream_t s) {
  const Launch l = agg_launch<multi_agg_kernel<T, M, L>, T, L>(C, D, 1, false);
  multi_agg_kernel<T, M, L><<<static_cast<unsigned int>(l.grid), l.n_warps * 32, l.smem, s>>>(
      static_cast<const T*>(g), w, out, C, D, l.plan);
}

template <typename T, int M>
void launch_multi_l(const void* g, const float* w, float* out, int C, int64_t D, cudaStream_t s) {
  if (vector_rows<T>(g, D))
    launch_multi<T, M, Vec<T>::N>(g, w, out, C, D, s);
  else
    launch_multi<T, M, 1>(g, w, out, C, D, s);
}

template <typename T>
int dispatch_multi(const void* g, const float* w, float* out, int C, int64_t D, int M,
                   cudaStream_t s) {
  switch (M) {
    case 1: launch_multi_l<T, 1>(g, w, out, C, D, s); break;
    case 2: launch_multi_l<T, 2>(g, w, out, C, D, s); break;
    case 3: launch_multi_l<T, 3>(g, w, out, C, D, s); break;
    case 4: launch_multi_l<T, 4>(g, w, out, C, D, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2 takes at least 4 warps a block where C has the rows, so its
// last block sums the partials with at least 128 threads.
constexpr int kCohortMinWarps = 4;

template <typename T, int L>
Launch cohort_launch(int C, int64_t D) {
  return agg_launch<cohort_agg_kernel<T, L>, T, L>(C, D, kCohortMinWarps, true);
}

template <typename T, int L>
void launch_cohort(const void* g, const float* w, const float* lam, float* d, float* partials,
                   unsigned int* counter, float* err, int C, int64_t D, cudaStream_t s) {
  const Launch l = cohort_launch<T, L>(C, D);
  cohort_agg_kernel<T, L><<<static_cast<unsigned int>(l.grid), l.n_warps * 32, l.smem, s>>>(
      static_cast<const T*>(g), w, lam, d, partials, counter, err, C, D, l.plan);
}

template <typename T>
int dispatch_cohort(const void* g, const float* w, const float* lam, float* d, float* partials,
                    unsigned int* counter, float* err, int C, int64_t D, cudaStream_t s) {
  if (vector_rows<T>(g, D))
    launch_cohort<T, Vec<T>::N>(g, w, lam, d, partials, counter, err, C, D, s);
  else
    launch_cohort<T, 1>(g, w, lam, d, partials, counter, err, C, D, s);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2's grid for (C, D, g's dtype and base pointer).
template <typename T>
int64_t cohort_blocks(const void* g, int C, int64_t D) {
  return vector_rows<T>(g, D) ? cohort_launch<T, Vec<T>::N>(C, D).grid
                              : cohort_launch<T, 1>(C, D).grid;
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

// Number of column tiles (blocks) of kernels 3 and 4 for D columns of the
// given dtype: the rows of the partials buffers they take.
long long fwa_num_tiles(long long D, int dtype) { return n_tiles(D, dtype); }

// Number of blocks kernel 2 launches for g (C, D) of the given dtype at
// this base pointer on the current device: the length of the partials
// buffer fwa_cohort_agg_and_error takes.
long long fwa_cohort_blocks(const void* g, int dtype, int C, long long D) {
  if (dtype == kF32) return cohort_blocks<float>(g, C, D);
  return cohort_blocks<__nv_bfloat16>(g, C, D);
}

// Largest M fwa_multi_weighted_agg takes.
int fwa_max_rows() { return 4; }

int fwa_multi_weighted_agg(const void* g, int dtype, const float* w, float* out, int C,
                           long long D, int M, void* stream) {
  if (C < 1 || D < 1 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_multi<float>(g, w, out, C, D, M, s);
  return dispatch_multi<__nv_bfloat16>(g, w, out, C, D, M, s);
}

// partials: fwa_cohort_blocks(g, dtype, C, D) floats of scratch.  counter: one
// unsigned int that is 0 before the launch and is 0 again after it; two
// launches that may overlap (other streams) need two counters.
int fwa_cohort_agg_and_error(const void* g, int dtype, const float* w, const float* lam,
                             float* d, float* partials, unsigned int* counter, float* err,
                             int C, long long D, void* stream) {
  if (C < 1 || D < 1 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_cohort<float>(g, w, lam, d, partials, counter, err, C, D, s);
  return dispatch_cohort<__nv_bfloat16>(g, w, lam, d, partials, counter, err, C, D, s);
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
