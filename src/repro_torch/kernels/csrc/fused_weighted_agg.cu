// Fused weighted aggregation of stacked client deltas, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/fused_weighted_agg.py:
//
//   fwa_weighted_agg          <- fused_weighted_agg (:134, pallas_call :146)
//       d (D,) f32 = sum_c w_c g_c and sq (C,) f32 = ||g_c||^2, one read of g.
//       Bound: bytes, C * D * es + (C + D + C) * 4 (g, w, d, sq).
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
// the one to watch: one byte per element carries a widening and three FMAs
// (d, the error row, the row's norm), about 5 operations per byte, and
// Hopper converts an int8 value to f32 (I2F) at an eighth of the FMA rate,
// so at the full HBM rate the conversions alone would take most of the
// conversion pipe.  Kernel 4 widens int8 by a byte permute instead (the code
// plus 128 as the low byte of the float 2^23, minus 2^23 + 128: exact, on the
// integer and FMA pipes), and fp8 by the paired e4m3x2 -> f16x2 convert.
//
// Design.  The TPU kernels walk a sequential grid over D and carry their
// sums (the squared error, the (C,) norms) in VMEM scratch from step to step.
// Hopper's blocks run in parallel and in no order, so here:
//   * every element of g is loaded exactly once, by one thread, which keeps
//     its accumulators in registers in f32 and reads g with 16-byte vector
//     loads when every row starts 16-byte aligned (V = 16 bytes / the element
//     size: 4 f32, 8 bf16, 16 int8 or fp8; kernel 4 also needs the scale
//     block a multiple of 16); otherwise with V scalar loads spaced a warp
//     apart, still coalesced across the warp, masking the ragged edge, so any D and any scale block
//     are valid;
//   * kernels 1-4 split C inside the block: a tile is one warp's width
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
//     own theirs); kernels 2-4 at most the blocks resident at once, each
//     walking its share of the tiles with the next batch in flight.  The
//     logreg shape (C = 100, D = 610) is 5 tiles of 13 warps, one batch a
//     warp (f32); kernel 1 needs no pass across blocks;
//   * kernel 4 copies each row's scale with its codes (cp.async, 4 bytes a
//     lane: the lane's 16 columns lie in one scale block), reads a batch
//     from shared memory 4 rows at a time (codes, scales and weights of the
//     4 rows loaded before the first is widened), takes the scale into the
//     row's weights, w * s and (w - lam) * s, and skips the batch's rows
//     past the warp's; int8 squares are summed exactly by dp4a.  On the
//     scalar path each value is multiplied by its own scale (the block
//     index by a precomputed reciprocal), loaded with the unit;
//   * kernels 3 and 4 keep the per-row norms: a lane's squared row sums of
//     a batch are reduced over the warp once a batch (a reduce-scatter: 9
//     shuffles for 8 rows) and added to the warp's row norms in shared
//     memory, off the loads' path.  Kernel 3 is kernel 2's walk with one
//     weight row (M = 1) and these norms in place of the error: the TPU
//     kernel's sequential grid carried the (C,) norms in VMEM from tile to
//     tile; here each block writes its row of C partial norms;
//   * no float atomics anywhere: a cross-block sum is written as one partial
//     per block and summed in a fixed order, so repeated runs are bitwise
//     equal.  Kernels 2-4 do it in their one launch: the last block to
//     finish, found by an integer atomic ticket (kernel 2: after a
//     __threadfence; kernels 3 and 4: acquire-release), sums the partials
//     in index order (kernel 3's C-wide and kernel 4's (C + 1)-wide rows,
//     the norms and kernel 4's error, column by column, with 16-byte loads
//     split over the block's threads and the row slices added in order).
// Kernels 3 and 4 take C up to the shared memory their row norms need (4
// bytes a row a warp beside the stages: about 13,000 rows where the warps
// own their tiles, more where they split C, on an H100).  What holds
// kernel 4 back at huge D (PERF.md §6): the SMs, not HBM nor the
// widening.  The int8 walk issues about 80 instructions a 16-code row at 116
// registers (16 warps an SM); in one-off builds, I2F in place of the byte
// permutes and 2 or 8 rows a sub-batch in place of 4 timed the same, and
// kernel 2's own cp.async path also fell well short of the HBM rate there.
// Not used: TMA, wgmma.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError() (0 = ok).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

// Kernel 4's 16 codes (one 16-byte vector) as f32, and the sum of their
// squares.  int8: the code + 128 as the low byte of the float 2^23, minus
// 2^23 + 128 (byte permutes and adds, no I2F), and the squares by dp4a,
// both exact.  fp8: the paired convert to half (exact: half covers e4m3's
// range and precision, and so does f32), then FMAs.
template <typename T>
__device__ __forceinline__ float widen_codes(int4 v, float* out);

template <>
__device__ __forceinline__ float widen_codes<int8_t>(int4 v, float* out) {
  const int raw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    out[k] = __uint_as_float(__byte_perm(static_cast<uint32_t>(raw[k / 4]) ^ 0x80808080u,
                                         0x4b000000u, 0x7540u | (k % 4))) -
             8388736.f;
  return static_cast<float>(
      __dp4a(raw[0], raw[0], __dp4a(raw[1], raw[1], __dp4a(raw[2], raw[2], __dp4a(raw[3], raw[3], 0)))));
}

template <>
__device__ __forceinline__ float widen_codes<Fp8>(int4 v, float* out) {
  const uint32_t words[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                             static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const auto pair = static_cast<__nv_fp8x2_storage_t>(words[k / 2] >> (16 * (k % 2)));
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
  float q2 = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) q2 = fmaf(out[k], out[k], q2);
  return q2;
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

// Kernel 4's element types: codes with a scale per (row, scale block).
template <typename T>
constexpr bool kIsCode = std::is_same_v<T, int8_t> || std::is_same_v<T, Fp8>;

// Kernel 4's scales: (C, nb) f32, one per row and block of sb columns, with
// the multiplier and shift that divide a column index below 2^31 by sb
// (mul = 0: divide).
struct Scales {
  const float* p;
  int64_t nb;
  int64_t sb;
  uint32_t mul;
  int shift;
};

Scales make_scales(const float* p, int64_t nb, int64_t sb) {
  Scales sc{p, nb, sb, 0u, 0};
  if (sb >= 2 && sb <= INT32_MAX) {  // round-up reciprocal: exact for dividends < 2^31
    int log2_ceil = 0;
    while ((int64_t{1} << log2_ceil) < sb) ++log2_ceil;
    const int p2 = 31 + log2_ceil;
    sc.mul = static_cast<uint32_t>(((uint64_t{1} << p2) + sb - 1) / sb);
    sc.shift = p2 - 32;
  }
  return sc;
}

// The scale block of column col: col / sb.
__device__ __forceinline__ int64_t scale_block(int64_t col, const Scales& sc) {
  if (sc.sb == 1) return col;
  if (sc.mul != 0u && col <= INT32_MAX)
    return __umulhi(static_cast<uint32_t>(col), sc.mul) >> sc.shift;
  return col / sc.sb;
}

// Sum R values a lane over the warp, row u's being the lanes' v[u]: a
// reduce-scatter (lanes that differ in bit 16 swap halves of the rows, then
// bit 8, ... down to one row a lane), then plain shuffles over the lanes
// left.  Returns the sum of row (lane >> (5 - log2 R)) & (R - 1), which the
// lanes with (lane & (32 / R - 1)) == 0 own.  R is a power of two <= 32.
template <int R>
__device__ __forceinline__ float reduce_rows(float (&v)[R], int lane) {
  int o = 16;
#pragma unroll
  for (int h = R / 2; h >= 1; h /= 2, o /= 2) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float t = v[0];
#pragma unroll
  for (; o >= 1; o /= 2) t += __shfl_xor_sync(kFull, t, o);
  return t;
}

// Kernels 1, 2 and 4: C split over the warps of a block.  A tile is 32 * V
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
constexpr int kSlotBytes = 32 * 16;  // one row of a warp's batch in shared memory (codes: + scales)
constexpr int kSumBatch = 16;  // partials a thread of kernel 2's last block loads at once

// A row's slot in a warp's stage: a 16-byte vector a lane, and for kernel
// 4 the lane's scale of the row after the 32 vectors.
template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return kSlotBytes + (kIsCode<T> ? 32 * static_cast<int>(sizeof(float)) : 0);
}

// Rows of a warp's unit of work: kRowBatch through shared memory; with
// scalars 32 values a lane, since a lane holds two units.
template <typename T, int L>
__host__ __device__ constexpr int unit_rows() {
  return L == Vec<T>::N ? kRowBatch : 32 / Vec<T>::N;
}

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

// 4 bytes global -> shared.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest N groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows c0 .. min(c0 + kRowBatch, r1) - 1 of the tile at tile0 into
// `stage`, row u to the lane's slot at u * slot_bytes + lane * 16; a lane
// past D copies the row's last vector, which staged_values ignores.
// Kernel 4 (codes) also copies the lane's scale of each row (its 16
// columns lie in one scale block) to u * slot_bytes + kSlotBytes + lane * 4.
template <typename T>
__device__ __forceinline__ void issue_batch(const T* __restrict__ g, int64_t D, int c0, int r1,
                                            int64_t tile0, int lane, unsigned char* stage,
                                            const Scales& sc) {
  constexpr int V = Vec<T>::N;
  constexpr int kSlot = slot_bytes<T>();
  const int64_t col = tile0 + lane * V < D ? tile0 + lane * V : D - V;
  int64_t blk = 0;
  if constexpr (kIsCode<T>) blk = scale_block(col, sc);
#pragma unroll
  for (int u = 0; u < kRowBatch; ++u) {
    if (c0 + u < r1) {
      cp_async16(smem_u32(stage + u * kSlot + lane * 16), g + static_cast<int64_t>(c0 + u) * D + col);
      if constexpr (kIsCode<T>)
        cp_async4(smem_u32(stage + u * kSlot + kSlotBytes + lane * 4),
                  sc.p + static_cast<int64_t>(c0 + u) * sc.nb + blk);
    }
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
      load_vec(reinterpret_cast<const T*>(stage + u * slot_bytes<T>() + lane * 16), x[u]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) x[u][k] = 0.f;
    }
  }
}

// Kernel 4, scalars: x[u][j] *= the scale of g[c0 + u, tile0 + j * 32 +
// lane] (the scale blocks found once for the unit's rows).
template <typename T, int R>
__device__ __forceinline__ void scale_values(const Scales& sc, int64_t D, int c0, int r1,
                                             int64_t tile0, int lane, float (&x)[R][Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  int64_t blk[V];
#pragma unroll
  for (int j = 0; j < V; ++j) blk[j] = scale_block(min(tile0 + j * 32 + lane, D - 1), sc);
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const float* row = sc.p + static_cast<int64_t>(min(c0 + u, r1 - 1)) * sc.nb;
#pragma unroll
    for (int j = 0; j < V; ++j) x[u][j] *= row[blk[j]];
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

// No per-row callback (kernels 1 and 2).
struct NoRows {
  template <typename A>
  __device__ void operator()(int, const A&) const {}
};

// Walk the block's tiles (with plan.own, the warp's own): acc[m][j * L + e]
// = sum over the warp's rows c of wt_m(c) * g[c, tile0 + j * 32 * L +
// lane * L + e], in row order, then on_tile(tile0, acc), which every warp
// of the block reaches together unless the warps own their tiles.
// Kernel 1's weights are w[m * C + c]; kernels 2 and 4's (kCohort, M = 2)
// w[c] and w[c] - lam[c].  `stages` is the warp's plan.stages stages.
// Kernel 3 (kCohort, M = 1) takes w[c] alone.  Kernel 4 (codes): g[c, col]
// = float(code) * scale.  Kernels 3 and 4 (an on_rows callback): after each
// unit of rows c0 .. c0 + R - 1, on_rows(c0, sq) with sq[u] the lane's sum
// of g[c0 + u, col]^2 over its columns of the tile (every lane calls it).
template <typename T, int M, int L, bool kCohort, typename OnTile, typename OnRows = NoRows>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ g, const float* __restrict__ w,
                                           const float* __restrict__ lam, int C, int64_t D,
                                           AggPlan plan, unsigned char* stages, OnTile on_tile,
                                           Scales sc = {}, OnRows on_rows = {}) {
  constexpr int V = Vec<T>::N;
  constexpr int kTile = 32 * V;
  constexpr bool kCode = kIsCode<T>;
  constexpr bool kRowSums = !std::is_same_v<OnRows, NoRows>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int r0 = plan.own ? 0 : warp * plan.rpw, r1 = min(C, r0 + plan.rpw);
  constexpr int R = unit_rows<T, L>();
  const int n_batches = (plan.rpw + R - 1) / R;  // the same in every warp
  const int64_t n_tiles = (D + kTile - 1) / kTile;
  // The warp's tiles: first, first + stride, ... (the block's, or its own);
  // its units tile by tile, batch b of a tile its rows r0 + b * R ...
  const int64_t stride = plan.own ? static_cast<int64_t>(gridDim.x) * n_warps : gridDim.x;
  int64_t tile = plan.own ? static_cast<int64_t>(blockIdx.x) * n_warps + warp : blockIdx.x;
  int b = 0;
  int64_t next_tile = n_batches > 1 ? tile : tile + stride;  // the unit after (tile, b)
  int next_b = n_batches > 1 ? 1 : 0;
  const int stage_bytes = plan.batch_rows * slot_bytes<T>();
  int s = 0;  // the current unit's stage
  float acc[M][V];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[m][k] = 0.f;
  }
  float x[R][V];  // the current unit's values (kernel 4's vectors: read a row at a time)
  if constexpr (L == V) {
    if (tile < n_tiles) issue_batch<T>(g, D, r0, r1, tile * kTile, lane, stages, sc);
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
                         stages + (s ^ 1) * stage_bytes, sc);
        cp_async_commit();  // possibly empty: one group an iteration
        cp_async_wait<1>();
      } else {  // one stage: the warp's only unit
        cp_async_wait<0>();
      }
      if constexpr (!kCode) staged_values<T>(D, c0, r1, tile0, lane, stages + s * stage_bytes, x);
    } else {
      if (next_tile < n_tiles)
        scalar_values<T, R>(g, D, r0 + next_b * R, r1, next_tile * kTile, lane, x_next);
      if constexpr (kCode) scale_values<T, R>(sc, D, c0, r1, tile0, lane, x);
    }
    if constexpr (kCode) {
      // Rows in sub-batches of kSub: a sub-batch's codes, scales and weights
      // are all loaded before its first row is widened (loaded row by row,
      // each row waited on its loads); the scale goes into the weights where
      // one scale covers the lane's columns.  Rows past the warp's are
      // skipped (uniform over the warp).
      constexpr int kSub = R < 4 ? R : 4;
      const unsigned char* stage = stages + s * stage_bytes;
      const bool in = tile0 + lane * V < D;
      float sq[R];
#pragma unroll
      for (int h = 0; h < R; h += kSub) {
        float wa[kSub], wb[kSub], sc_u[kSub];
        int4 raw[kSub];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          // Rows past the warp's load its last row's (the stage holds only
          // the batch's rows) and are skipped below.
          const int uu = min(h + u, r1 - 1 - c0);
          wa[u] = w[c0 + uu];
          wb[u] = lam[c0 + uu];
          if constexpr (L == V) {
            const unsigned char* slot = stage + uu * slot_bytes<T>();
            raw[u] = *reinterpret_cast<const int4*>(slot + lane * 16);
            sc_u[u] = *reinterpret_cast<const float*>(slot + kSlotBytes + lane * 4);
          }
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          sq[h + u] = 0.f;
          if (c0 + h + u >= r1) continue;
          float v[V];
          float scale = 1.f, q2 = 0.f;
          if constexpr (L == V) {
            if (in) {
              q2 = widen_codes<T>(raw[u], v);
            } else {
#pragma unroll
              for (int k = 0; k < V; ++k) v[k] = 0.f;
            }
            scale = sc_u[u];
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              v[k] = x[h + u][k];
              q2 = fmaf(v[k], v[k], q2);
            }
          }
          const float w0 = wa[u] * scale;
          const float w1 = (wa[u] - wb[u]) * scale;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            acc[0][k] = fmaf(w0, v[k], acc[0][k]);
            acc[M - 1][k] = fmaf(w1, v[k], acc[M - 1][k]);
          }
          sq[h + u] = q2 * (scale * scale);
        }
      }
      on_rows(c0, sq);
    } else {
      float sq[R];  // rows past r1 and columns past D are zero and add nothing
#pragma unroll
      for (int u2 = 0; u2 < R; ++u2) {
        const int c = c0 + u2;
        const bool row = c < r1;
        float wt[M];
        if (kCohort) {
          wt[0] = row ? w[c] : 0.f;
          if constexpr (M > 1) wt[M - 1] = row ? w[c] - lam[c] : 0.f;
        } else {
#pragma unroll
          for (int m = 0; m < M; ++m) wt[m] = row ? w[static_cast<int64_t>(m) * C + c] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
#pragma unroll
          for (int k = 0; k < V; ++k) acc[m][k] = fmaf(wt[m], x[u2][k], acc[m][k]);
        }
        if constexpr (kRowSums) {
          sq[u2] = 0.f;
#pragma unroll
          for (int k = 0; k < V; ++k) sq[u2] = fmaf(x[u2][k], x[u2][k], sq[u2]);
        }
      }
      if constexpr (kRowSums) on_rows(c0, sq);
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

// Dynamic shared memory of kernels 1-4: each warp's stages, then the tile
// sums of one row (none where the warps own their tiles).  With row norms
// (kernels 3 and 4) the last block reuses that front for its column sums
// (16 bytes a thread), and after it come the warps' row norms (plan.rpw
// floats a warp).
template <typename T>
__host__ __device__ constexpr size_t agg_front_bytes(int n_warps, AggPlan plan, bool norms) {
  const size_t walk = static_cast<size_t>(n_warps) * plan.stages * plan.batch_rows * slot_bytes<T>() +
                      (plan.own ? 0 : static_cast<size_t>(n_warps) * 32 * Vec<T>::N * sizeof(float));
  const size_t sums = static_cast<size_t>(n_warps) * 32 * 16;
  return norms && sums > walk ? sums : walk;
}

template <typename T>
constexpr size_t agg_smem_bytes(int n_warps, AggPlan plan, bool norms) {
  return agg_front_bytes<T>(n_warps, plan, norms) +
         (norms ? static_cast<size_t>(n_warps) * plan.rpw * sizeof(float) : 0);
}

// Kernel 3 (M = 1) and kernel 4 (codes) carry the per-row norms.
template <typename T, int M>
constexpr bool kRowNorms = kIsCode<T> || M == 1;

// Kernel 3's and 4's row of partials a block: the C norms (kernel 4: and
// the error), padded to whole 16-byte vectors.
__host__ __device__ constexpr int partials_stride(int n_out) { return (n_out + 3) & ~3; }

// True in every thread of the block that took the last of `expected`
// tickets on *counter; that block sets the counter back to 0 for the next
// launch on the stream.  After the barrier, thread 0 takes the ticket with
// an acquire-release atomic at device scope: it releases the whole block's
// writes (cumulative over the barrier) and, for the last block, acquires
// every other block's (the SM's L1 is invalidated), so that block may read
// them with plain loads after the second barrier.
__device__ __forceinline__ bool last_arrival(unsigned int* counter, unsigned int expected) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(ticket) : "l"(counter) : "memory");
    last = ticket == expected - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  return last;
}

// Kernel 3's or 4's last block: sums[j] = sum over the n_rows rows of
// partials[:, j] for j < n_out, partials (n_rows, stride) with stride a
// multiple of 4.  Thread t sums column quad t % nq over rows t / nq,
// t / nq + P, ... (P = blockDim / nq row slices) with 16-byte loads, and the
// slices are added in order through `red` (blockDim float4 of shared
// memory); where nq >= blockDim, each thread sums whole quads.
__device__ void sum_partial_columns(const float* partials, int n_rows, int stride,
                                    int n_out, float* __restrict__ sums, float4* red) {
  const int t = threadIdx.x, bd = blockDim.x, nq = stride / 4;
  const float4* p4 = reinterpret_cast<const float4*>(partials);
  auto emit = [&](int q, float4 v) {
    const float c4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * q + i < n_out) sums[4 * q + i] = c4[i];
    }
  };
  // kSumBatch rows' loads in flight before any add (rows past n_rows load
  // the last row, then add nothing): plain loads, after last_arrival's
  // acquire.
  auto column = [&](int q, int first, int step) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = first; r0 < n_rows; r0 += kSumBatch * step) {
      float4 v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        v[u] = p4[static_cast<int64_t>(min(r0 + u * step, n_rows - 1)) * nq + q];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (r0 + u * step < n_rows) {
          a.x += v[u].x;
          a.y += v[u].y;
          a.z += v[u].z;
          a.w += v[u].w;
        }
      }
    }
    return a;
  };
  if (nq >= bd) {
    for (int q = t; q < nq; q += bd) emit(q, column(q, 0, 1));
    return;
  }
  const int slices = bd / nq, q = t % nq, p = t / nq;
  if (p < slices) red[p * nq + q] = column(q, p, slices);
  __syncthreads();
  if (t < nq) {
    float4 tot = red[t];
    for (int i = 1; i < slices; ++i) {
      const float4 v = red[i * nq + t];
      tot.x += v.x;
      tot.y += v.y;
      tot.z += v.z;
      tot.w += v.w;
    }
    emit(t, tot);
  }
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

// Kernels 2, 3 and 4 in one launch: each block writes d over its tiles and
// its partial of the error row's squared norm (kernel 2), or its row of
// partials at partials[blockIdx.x * stride] (kernel 3: the C row norms;
// kernel 4: the C row norms, then the error); the last block to finish (an
// integer ticket on *counter) sums all partials in index order into out
// (kernel 2: the error; kernel 3: the C norms; kernel 4: the C norms, then
// the error) and sets *counter back to 0 for the next launch on the stream.
// M = 2 carries the error row (kernels 2 and 4), M = 1 only d (kernel 3).
template <typename T, int L, int M>
__global__ void __launch_bounds__(kMaxAggWarps * 32)
    cohort_agg_kernel(const T* __restrict__ g, Scales sc, const float* __restrict__ w,
                      const float* __restrict__ lam, float* __restrict__ d,
                      float* __restrict__ partials, unsigned int* __restrict__ counter,
                      float* __restrict__ out, int C, int64_t D, AggPlan plan) {
  constexpr int V = Vec<T>::N;
  constexpr int kTile = 32 * V;
  constexpr int R = unit_rows<T, L>();
  constexpr bool kNorms = kRowNorms<T, M>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[kMaxAggWarps];
  __shared__ bool last;
  const int n_warps = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stage_bytes = plan.stages * plan.batch_rows * slot_bytes<T>();
  float* red = reinterpret_cast<float*>(smem + n_warps * stage_bytes);
  // Kernels 3 and 4: the warp's row norms, rows r0 .. r1 - 1 at row_sq[c - r0].
  float* row_sq = reinterpret_cast<float*>(smem + agg_front_bytes<T>(n_warps, plan, kNorms)) +
                  warp * plan.rpw;
  const int r0 = plan.own ? 0 : warp * plan.rpw, r1 = min(C, r0 + plan.rpw);
  if constexpr (kNorms) {
    for (int i = lane; i < plan.rpw; i += 32) row_sq[i] = 0.f;
    __syncwarp();
  }
  float sq = 0.f;  // columns past D sum to zero and add nothing
  auto on_tile = [&](int64_t tile0, const float (&acc)[M][V]) {
    if (plan.own) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t col = tile0 + tile_col<V, L>(k, lane);
        if (col < D) d[col] = acc[0][k];
        if constexpr (M == 2) sq = fmaf(acc[1][k], acc[1][k], sq);
      }
      return;
    }
    __syncthreads();  // the previous tile's sums are read
    stage_warp_sums<V, L>(acc[0], red);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      if (tile0 + i < D) d[tile0 + i] = sum_warps<V>(red, i);
    }
    if constexpr (M == 2) {
      __syncthreads();
      stage_warp_sums<V, L>(acc[1], red);
      __syncthreads();
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const float e = sum_warps<V>(red, i);
        sq = fmaf(e, e, sq);
      }
    }
  };
  if constexpr (kNorms) {
    walk_tiles<T, M, L, true>(g, w, lam, C, D, plan, smem + warp * stage_bytes, on_tile, sc,
                              [&](int c0, float (&rows)[R]) {
                                const float v = reduce_rows<R>(rows, lane);
                                const int c = c0 + ((lane * R) >> 5);
                                if ((lane & (32 / R - 1)) == 0 && c < r1) row_sq[c - r0] += v;
                              });
    // The block's row of partials: each row's norm over its warps, in warp
    // order (one warp a row where the warps split C), then kernel 4's error.
    const int n_out = C + (M == 2);
    const int stride = partials_stride(n_out);
    if constexpr (M == 2) sq = block_sum(sq, scratch);
    float* mine = partials + static_cast<int64_t>(blockIdx.x) * stride;
    const float* all_rows = row_sq - warp * plan.rpw;
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float v = 0.f;
      for (int w8 = 0; w8 < n_warps; ++w8) {
        const int w0 = plan.own ? 0 : w8 * plan.rpw;
        if (c >= w0 && c < w0 + plan.rpw) v += all_rows[w8 * plan.rpw + c - w0];
      }
      mine[c] = v;
    }
    if constexpr (M == 2) {
      if (threadIdx.x == 0) mine[C] = sq;
    }
    if (!last_arrival(counter, gridDim.x)) return;
    sum_partial_columns(partials, gridDim.x, stride, n_out, out, reinterpret_cast<float4*>(smem));
  } else {
    walk_tiles<T, M, L, true>(g, w, lam, C, D, plan, smem + warp * stage_bytes, on_tile, sc);
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
      *out = t;
      *counter = 0u;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Blocks of one kernel resident on the current device at once, for a
// block size and dynamic shared memory (asked once each).  The kernel is
// first allowed the largest shared memory a launch of it takes: for kernels
// 1 and 2 the largest plan's, for kernels 3 and 4 (`norms`), whose row
// norms grow with C, all the device gives a block.
template <auto Kernel, typename T>
int resident_blocks(int n_warps, size_t smem, bool norms) {
  struct Entry {
    int dev, n_warps;
    size_t smem;
    int n;
  };
  static Entry cache[64] = {};
  static int next = 0;
  static bool allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!allowed[dev & 63]) {
    int max_smem = static_cast<int>(agg_smem_bytes<T>(kMaxAggWarps, {0, kRowBatch, 2, 0}, false));
    if (norms) {
      cudaFuncAttributes attr;
      cudaFuncGetAttributes(&attr, Kernel);
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      max_smem -= static_cast<int>(attr.sharedSizeBytes);
    }
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    allowed[dev & 63] = true;
  }
  for (const Entry& e : cache) {
    if (e.n > 0 && e.dev == dev && e.n_warps == n_warps && e.smem == smem) return e.n;
  }
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, n_warps * 32, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n = std::max(1, per_sm * sms);
  cache[next++ % 64] = {dev, n_warps, smem, n};
  return n;
}

// A launch of kernel 1, 2, 3 or 4 (Kernel, element type T, chunk width L,
// row norms or not) for C
// rows of D columns.  Tiles enough to fill the card (huge D), or at most
// two batches of rows with a block for every SM, take blocks of kOwnWarps
// warps, each warp walking all C rows of tiles of its own; otherwise a
// block's warps split C, about kRowsPerWarp rows a warp, at
// least min_warps and at most kMaxAggWarps warps, no warp without rows.
// Every tile gets a warp (or a block), or, with `bounded`, the grid is at
// most the blocks resident at once (kernels 2-4, whose last block sums a
// row of partials a block).  Vectors take two stages where a warp has more than
// one unit of work.
struct Launch {
  AggPlan plan;
  int n_warps;
  int64_t grid;
  size_t smem;
};

template <auto Kernel, typename T, int L>
Launch agg_launch(int C, int64_t D, int min_warps, bool bounded, bool norms) {
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
  const auto resident = [&] {
    return resident_blocks<Kernel, T>(l.n_warps, agg_smem_bytes<T>(l.n_warps, l.plan, norms), norms);
  };
  if (bounded && l.grid > resident()) {
    if (async) l.plan.stages = 2;
    l.grid = resident();
  }
  l.smem = agg_smem_bytes<T>(l.n_warps, l.plan, norms);
  if (l.smem > 48 * 1024) resident();  // allows it
  return l;
}

// Whether every row of g starts 16-byte aligned (L = V) or not (L = 1);
// for kernel 4 also whether a vector of codes lies in one scale block of sb.
template <typename T>
bool vector_rows(const void* g, int64_t D, int64_t sb = Vec<T>::N) {
  return D % Vec<T>::N == 0 && sb % Vec<T>::N == 0 && aligned16(g);
}

template <typename T, int M, int L>
void launch_multi(const void* g, const float* w, float* out, int C, int64_t D, cudaStream_t s) {
  const Launch l = agg_launch<multi_agg_kernel<T, M, L>, T, L>(C, D, 1, false, false);
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

// Kernels 2-4 take at least 4 warps a block where C has the rows, so their
// last block sums the partials with at least 128 threads.
constexpr int kCohortMinWarps = 4;

template <typename T, int L, int M>
Launch cohort_launch(int C, int64_t D) {
  return agg_launch<cohort_agg_kernel<T, L, M>, T, L>(C, D, kCohortMinWarps, true,
                                                        kRowNorms<T, M>);
}

template <typename T, int L, int M>
void launch_cohort(const void* g, Scales sc, const float* w, const float* lam, float* d,
                   float* partials, unsigned int* counter, float* out, int C, int64_t D,
                   cudaStream_t s) {
  const Launch l = cohort_launch<T, L, M>(C, D);
  cohort_agg_kernel<T, L, M><<<static_cast<unsigned int>(l.grid), l.n_warps * 32, l.smem, s>>>(
      static_cast<const T*>(g), sc, w, lam, d, partials, counter, out, C, D, l.plan);
}

template <typename T, int M>
int dispatch_cohort(const void* g, Scales sc, const float* w, const float* lam, float* d,
                    float* partials, unsigned int* counter, float* out, int C, int64_t D,
                    cudaStream_t s) {
  if (vector_rows<T>(g, D, kIsCode<T> ? sc.sb : Vec<T>::N))
    launch_cohort<T, Vec<T>::N, M>(g, sc, w, lam, d, partials, counter, out, C, D, s);
  else
    launch_cohort<T, 1, M>(g, sc, w, lam, d, partials, counter, out, C, D, s);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2's, 3's (M = 1) or 4's grid for (C, D, g's dtype and base
// pointer; kernel 4's scale block).
template <typename T, int M>
int64_t cohort_blocks(const void* g, int C, int64_t D, int64_t sb = Vec<T>::N) {
  return vector_rows<T>(g, D, sb) ? cohort_launch<T, Vec<T>::N, M>(C, D).grid
                                  : cohort_launch<T, 1, M>(C, D).grid;
}

}  // namespace

extern "C" {

// Number of blocks kernel 2 launches for g (C, D) of the given dtype at
// this base pointer on the current device: the length of the partials
// buffer fwa_cohort_agg_and_error takes.
long long fwa_cohort_blocks(const void* g, int dtype, int C, long long D) {
  if (dtype == kF32) return cohort_blocks<float, 2>(g, C, D);
  return cohort_blocks<__nv_bfloat16, 2>(g, C, D);
}

// Floats of scratch fwa_weighted_agg takes for g (C, D) of the given dtype
// at this base pointer on the current device: its grid times the row of
// partials a block.
long long fwa_weighted_agg_partials(const void* g, int dtype, int C, long long D) {
  if (C < 1 || D < 1) return 0;
  const int64_t blocks =
      dtype == kF32 ? cohort_blocks<float, 1>(g, C, D) : cohort_blocks<__nv_bfloat16, 1>(g, C, D);
  return blocks * partials_stride(C);
}

// Floats of scratch fwa_dequant_cohort_agg takes for q (C, D) codes of the
// given dtype at this base pointer, with nb scale blocks a row, on the
// current device: its grid times the row of partials a block.
long long fwa_dequant_partials(const void* q, int dtype, int nb, int C, long long D) {
  if (C < 1 || D < 1 || nb < 1) return 0;
  const int64_t sb = D / nb;
  const int64_t blocks =
      dtype == kI8 ? cohort_blocks<int8_t, 2>(q, C, D, sb) : cohort_blocks<Fp8, 2>(q, C, D, sb);
  return blocks * partials_stride(C + 1);
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
    return dispatch_cohort<float, 2>(g, {}, w, lam, d, partials, counter, err, C, D, s);
  return dispatch_cohort<__nv_bfloat16, 2>(g, {}, w, lam, d, partials, counter, err, C, D, s);
}

// partials: fwa_weighted_agg_partials(g, dtype, C, D) floats of scratch,
// 16-byte aligned.  counter: as fwa_cohort_agg_and_error's.  sq: the C
// squared row norms.
int fwa_weighted_agg(const void* g, int dtype, const float* w, float* d, float* partials,
                     unsigned int* counter, float* sq, int C, long long D, void* stream) {
  if (C < 1 || D < 1 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_cohort<float, 1>(g, {}, w, nullptr, d, partials, counter, sq, C, D, s);
  return dispatch_cohort<__nv_bfloat16, 1>(g, {}, w, nullptr, d, partials, counter, sq, C, D, s);
}

// q: (C, D) int8 or fp8 codes; scales: (C, nb) f32 with D % nb == 0.
// partials: fwa_dequant_partials(q, dtype, nb, C, D) floats of scratch,
// 16-byte aligned.  counter: as fwa_cohort_agg_and_error's.
// sums: C + 1 floats, the C squared norms, then the error.
int fwa_dequant_cohort_agg(const void* q, int dtype, const float* scales, int nb,
                           const float* w, const float* lam, float* d, float* partials,
                           unsigned int* counter, float* sums, int C, long long D, void* stream) {
  if (C < 1 || D < 1 || nb < 1 || D % nb != 0 || (dtype != kI8 && dtype != kFP8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scales sc = make_scales(scales, nb, D / nb);
  if (dtype == kI8)
    return dispatch_cohort<int8_t, 2>(q, sc, w, lam, d, partials, counter, sums, C, D, s);
  return dispatch_cohort<Fp8, 2>(q, sc, w, lam, d, partials, counter, sums, C, D, s);
}

}  // extern "C"
