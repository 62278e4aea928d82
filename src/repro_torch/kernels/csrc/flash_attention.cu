// Flash attention (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:86
// flash_attention (pallas_call :117).  For q (B, H, S_q, hd), k and v
// (B, H / G, S_k, hd) in f32 or bf16, any strides with hd contiguous, query
// head h reading key/value head h / G (grouped-query attention; G = 1 is the
// TPU kernel's function):
//
//   logits = (q . k) * hd^-0.5, soft-capped (cap * tanh(x / cap)) BEFORE the
//            mask; masked logits (causal kpos > qpos, or outside the sliding
//            window kpos <= qpos - window) set to -2.3819763e38, not -inf;
//   out    = softmax(logits) . v, accumulated online in f32, written in q's
//            dtype.
//
// Keys at or past S_k never count and query rows at or past S_q are not
// written: any S_q and S_k are taken (the TPU wrapper asserts S % block == 0).
// A row masked everywhere averages v over the S_k keys, as the TPU kernel's
// -2.38e38 surrogate makes it do.
//
// Two kernels, chosen by the wrapper from dtype and hd alone:
//   * flash_attention_fwd_tc: bf16 with hd a multiple of 16 up to 128 (every
//     model of the port: hd 64 and 128).  Both products on the tensor cores.
//   * flash_attention_fwd_cudacore: f32, and bf16 with any other hd up to
//     256.  Both products on the CUDA cores in f32 (the first port's kernel,
//     unchanged).
//
// What bounds it on an H100.  At the smollm-360m prefill shape (B=8, H=15,
// S=512, hd=64, causal) the causal half is ~4.0 GFLOP against ~21 MB of q,
// k, v and out: ~190 operations per byte, below the ~295 at which the bf16
// tensor cores and not HBM set the limit, so the bound is the bytes
// (0.0063 ms).  Neither binds this kernel: at S=512 each block walks at
// most 8 kv tiles, and per tile the softmax between the two products
// (scale, cap, mask, max, exp, sum, rescale: ~7 instructions a score) and
// the ldmatrix traffic (one 16-byte K or V fragment per 2 mma) cost about
// as much issue time as the mma themselves.  Measured by chip_smoke.py
// (NVIDIA H100 80GB HBM3, 700 W): 0.042 ms there, 15% of the bound and
// 1.5x torch's scaled_dot_product_attention; the CUDA-core kernel took
// 0.39 ms.
//
// Tensor-core kernel.  A block of 4 warps owns one (batch, head, 64-row
// query tile) and loops over 64-key kv tiles; no wgmma, TMA or warp
// specialisation.  A trial with 8 warps (128 rows) at hd <= 64 ran 12%
// slower on (k)'s causal prefill (fewer, longer blocks with more masked work
// on the diagonal) and 4% faster at full attention; the prefills were all
// causal then, so 4 warps it is.  Whisper's bidirectional encoder (B=8,
// H=12, S=1500, hd=64) and the cross-attention of whisper and the vlm
// (S_q != S_k, S_k = 1500 and 1601, ragged against the 64-key tiles) run
// the same kernel without the causal skip: 0.284 ms for the encoder, 5.1x
// its operations bound and 1.79x scaled_dot_product_attention (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700 W), where an 8-warp trial is still to be made.
//   * Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, f32
//     accumulators in registers.  Each warp owns 16 query rows.
//       - Q·Kᵀ: A = the warp's Q rows (16 x hd), loaded once with ldmatrix
//         and kept in registers (hd/16 x 4 regs); B = a K tile, row-major
//         [key][d] in shared memory, which is Kᵀ in the col layout mma wants,
//         so plain ldmatrix.x4 gives two 8-key n-tiles of one 16-wide d step.
//       - P·V: A = P from registers; B = V [key][d] through ldmatrix.x4.trans
//         (two 8-wide d tiles of one 16-key step).
//   * Fragments (lane = 4g + t): an m16n8 f32 C tile holds rows g and g+8,
//     columns 2t and 2t+1.  The two C tiles of keys 16kk..16kk+15 are
//     exactly the m16n8k16 A fragment of that key step, so the scores are
//     converted to bf16 in place and P never touches shared memory
//     (FlashAttention-2's layout).  The plain decode path rounds its
//     probabilities to v's dtype before the product in the same way.
//   * Online softmax in registers: each thread holds two rows; the row max is
//     two xor-shuffles over the 4 lanes of a row; the running sum stays a
//     per-thread partial (the correction is the same on the 4 lanes) and is
//     reduced once at the end.  Scale, soft cap (tanhf of x * (1 / cap)) and
//     masks are applied to the f32 scores before the max, in that order,
//     each as one pass over the tile under a uniform branch (tested per
//     score, the branches cost more than the products).  exp(x - m) and the
//     rescale exp(m_prev - m_new) are ex2.approx.ftz((x - m) log2 e): a
//     kNeg - m that overflows to -inf gives 0, as expf's underflow does, so
//     a fully masked row still averages v.
//   * K/V tiles stay bf16 in shared memory: cp.async.cg 16-byte copies into
//     a 2-stage ring, tile i+1 in flight while tile i computes (a third
//     stage was no faster in a trial); rows past S_k (and columns past hd)
//     are zero-filled by the copy.  Rows are padded to hd + 8 elements (a
//     16-byte pad: a row starts 4 banks after the one before, so the 8 row
//     addresses of an ldmatrix phase hit 32 distinct banks).  Shared memory
//     [K0 | V0 | K1 | V1], 64 x (hd + 8) x 2 B each: 36 KB at hd <= 64,
//     68 KB at hd <= 128, with the SM's carveout set to the most shared
//     memory.  Q is staged through [K1 | V1] before the loop and the output
//     tile through [K0 | V0] after it, which then leaves with 16-byte row
//     stores.
//   * Registers: 128 a thread at hd <= 64 (four 4-warp blocks an SM; ptxas
//     spills 32 bytes, and a trial ran faster that way than with three blocks at
//     146 registers), as many as ptxas takes at hd <= 128 (two blocks).
//   * kv tiles wholly above the causal diagonal or outside the window of
//     the block's rows are not visited, and a warp skips the products of a
//     tile wholly masked for its 16 rows.  This is exact when every row keeps
//     a valid key: a fully masked tile before the row's first valid one is
//     wiped by the correction exp(-2.38e38 - m) = 0, and one after it adds
//     exp(-2.38e38 - m) = 0.  When some row of the tile is masked everywhere
//     (possible only with a window and S_q > S_k + window - 1), the block
//     walks every kv tile and no warp skips, as the TPU kernel does.  The
//     per-score mask runs only on tiles that cross the diagonal, the window
//     edge or S_k.
//   * Query tiles are launched last-first, so the causal tiles with the most
//     kv tiles start first.
//   * The wrapper hands this kernel 16-byte-aligned pointers and (batch,
//     head, seq) strides (the models' transposed views are; anything else
//     is copied first).
//
// CUDA-core kernel (f32; bf16 at other hd).  A block owns one (batch, head,
// 64-row query tile) and loops over the kv blocks itself:
//   * the query tile is staged once in shared memory, transposed (Qt[d][r]),
//     as f32, zeros past S_q and past hd;
//   * each kv block (BK keys) is staged as Kt[d][c] (transposed) and V[c][d];
//   * 128 threads: thread (rg, cg) = (tid / 8, tid % 8) computes the 4 x BK/8
//     logits of rows 4rg..4rg+3 and columns cg*BK/8..+BK/8-1 from 16-byte
//     shared-memory reads (1 + BK/32 float4 loads per d for 4*BK/8 FMAs);
//   * the row max and row sum of the online softmax are shuffles over the 8
//     lanes that share a row group; running max m, denominator l and the
//     correction exp(m_prev - m_new) are in registers, exactly the TPU
//     kernel's update;
//   * the probabilities go to shared memory (Pt[c][r]) and the same thread
//     accumulates its 4 rows x hd/8 output columns (acc in registers) from
//     float4 reads of Pt and V;
//   * kv blocks are skipped as in the tensor-core kernel, with the same
//     exactness condition.
// Shared memory: 68 KB (hd <= 64, 64-key blocks: three blocks an SM), 77 KB
// (hd <= 128, 32-key blocks: two an SM; with 64-key blocks it took 118 KB,
// one 4-warp block an SM, and ran 2x slower), 145 KB (hd <= 256, 32-key
// blocks), so dynamic shared memory is opted in per variant.
//
// Interface: two plain C functions, loaded with ctypes.  Each launches on
// the given stream, allocates nothing, and returns cudaGetLastError() (0 =
// ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kRM = 4;   // query rows per thread (16 row groups x 4)
constexpr float kNeg = -2.3819763e38f;

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

struct Strides {
  int64_t b, h, s;  // elements; hd is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int G, S_q, S_k, hd;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
};

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, hd a multiple of 16 up to 128)
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;     // keys per kv tile
constexpr int kTcStages = 2;  // K/V tiles in the cp.async ring
constexpr int kTcWarps = 4;   // warps a block, 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) . b (16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp, results below 2^-126 flush to 0,
// -inf gives 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kernel configuration: NW warps a block, 16 query rows each (BQ = 16 NW
// rows a block); HDP = hd rounded up to 64 or 128; FIXED: hd == HDP, so the
// d loops need no guard.  MINB asks the compiler for registers that let
// MINB blocks share an SM: 16 resident warps at hd <= 64 (128 registers a
// thread), 8 at hd <= 128.
template <int HDP_, bool FIXED_>
struct TcConfig {
  static constexpr int HDP = HDP_, NW = kTcWarps;
  static constexpr bool FIXED = FIXED_;
  static constexpr int MINB = (HDP <= 64 ? 16 : 8) / NW;
  static constexpr int BQ = 16 * NW;
  static constexpr int BK = kTcBK;
  static constexpr int LD = HDP + 8;                   // shared row stride, elements
  static constexpr int TILE = BK * LD;                 // one K or V tile, elements
  static constexpr int SMEM = kTcStages * 2 * TILE * 2;  // bytes
  static_assert(BQ <= 2 * BK, "the Q and output tiles fit one K/V stage");
};

template <typename C>
__global__ void __launch_bounds__(C::NW * 32, C::MINB) flash_fwd_tc_kernel(const Params p) {
  constexpr int HDP = C::HDP, BQ = C::BQ, BK = C::BK, LD = C::LD, TILE = C::TILE;
  constexpr int STAGES = kTcStages;
  constexpr bool FIXED = C::FIXED;
  constexpr int CH = HDP / 8;   // 16-byte chunks per row
  constexpr int NT = C::NW * 32;
  constexpr int KD = HDP / 16;  // 16-wide d steps of Q·Kᵀ
  extern __shared__ __align__(16) __nv_bfloat16 sm[];  // STAGES x [K | V]
  __nv_bfloat16* sQ = sm + (STAGES - 1) * 2 * TILE;  // before the loop: the last stage
  __nv_bfloat16* sO = sm;                            // after the loop: the first

  const int hd = FIXED ? HDP : p.hd;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / p.G;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.b + head * p.sq.h;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b + head * p.so.h;

  // The kv range this tile reads (module notes: skipping is exact only when
  // no row of the tile is masked everywhere).
  const int q_last = min(q0 + BQ, p.S_q) - 1;
  const bool walk_all = p.window > 0 && q_last - p.window + 1 > p.S_k - 1;
  int kv_lo = 0, kv_hi = p.S_k;
  if (!walk_all) {
    if (p.causal) kv_hi = min(p.S_k, q_last + 1);
    if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  }
  const int k_start = (kv_lo / BK) * BK;
  const int n_tiles = (kv_hi - k_start + BK - 1) / BK;

  auto load_kv = [&](int tile) {
    const int k0 = k_start + tile * BK;
    __nv_bfloat16* ks = sm + (tile % STAGES) * 2 * TILE;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool ok = k0 + r < p.S_k && c * 8 < hd;
      const int64_t row = ok ? k0 + r : 0;
      const int col = ok ? c * 8 : 0;
      cp_async16(smem_u32(ks + r * LD + c * 8), kg + row * p.sk.s + col, ok);
      cp_async16(smem_u32(ks + TILE + r * LD + c * 8), vg + row * p.sv.s + col, ok);
    }
  };

  // Prologue: Q with the first K/V tile, then tiles 1 .. STAGES-2, one
  // commit group each; Q's fragments into registers.
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const bool ok = q0 + r < p.S_q && c * 8 < hd;
    const int64_t row = ok ? q0 + r : 0;
    cp_async16(smem_u32(sQ + r * LD + c * 8), qg + row * p.sq.s + (ok ? c * 8 : 0), ok);
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();

  const int wr = warp * 16;  // the warp's first row in the tile
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    if (FIXED || kk * 16 < hd)
      ldsm_x4(smem_u32(sQ + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                       (lane >> 4) * 8),
              qf[kk]);
  }

  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  const int wq0 = q0 + wr;   // the warp's first query position
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_start + it * BK;
    // Tile it has landed (at most the STAGES-2 younger groups in flight);
    // after the barrier every warp is done with tile it-1, whose stage (the
    // first iteration: Q's) the next copy refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    cp_async_commit();

    bool skip = false;  // the tile is masked for all 16 rows of this warp
    if (!walk_all) {
      if (p.causal && k0 > wq0 + 15) skip = true;
      if (p.window > 0 && k0 + BK - 1 <= wq0 - p.window) skip = true;
    }
    if (skip) continue;
    const __nv_bfloat16* ks = sm + (it % STAGES) * 2 * TILE;
    const __nv_bfloat16* vs = ks + TILE;

    // S = Q·Kᵀ: 16 rows x 64 keys a warp.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (!FIXED && kk * 16 >= hd) continue;
#pragma unroll
      for (int jn = 0; jn < BK / 16; ++jn) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(ks + (jn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8),
                kb);
        mma_bf16(s[2 * jn], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jn + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Scale, cap, mask, each a pass over the whole tile under one uniform
    // branch; row max over the 4 lanes of a row; P = exp(x - m).
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    if (p.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = p.softcap * tanhf(s[j][e] * inv_cap);
    }
    if (k0 + BK > p.S_k || (p.causal && k0 + BK - 1 > wq0) ||
        (p.window > 0 && k0 <= wq0 + 15 - p.window)) {
      // The tile crosses the diagonal, the window's edge or S_k.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = wq0 + g + (e >> 1) * 8;
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          bool ok = !p.causal || kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          const float x = ok ? s[j][e] : kNeg;
          s[j][e] = kpos < p.S_k ? x : -INFINITY;  // past S_k: never counts
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2_ftz((m[i] - m_new) * kLog2e);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_ftz((s[j][e] - m[e >> 1]) * kLog2e);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = corr[i] * l[i] + sum[i];
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P·V, P from the score registers as bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HDP / 16; ++dn) {
        if (!FIXED && dn * 16 >= hd) continue;
        uint32_t vb[4];
        ldsm_x4_trans(smem_u32(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               dn * 16 + (lane >> 4) * 8),
                      vb);
        mma_bf16(o[2 * dn], a, vb[0], vb[1]);
        mma_bf16(o[2 * dn + 1], a, vb[2], vb[3]);
      }
    }
  }

  // Normalise, stage the tile in shared memory, leave with 16-byte stores.
  __syncthreads();  // every warp is done with the last K/V stage
  float inv[2];     // 1 / row sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  }
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    if (!FIXED && n * 8 >= hd) continue;
    *reinterpret_cast<uint32_t*>(sO + (wr + g) * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (wr + g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncthreads();
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i - (i / CH) * CH;
    if (q0 + r < p.S_q && c * 8 < hd)
      *reinterpret_cast<uint4*>(og + (q0 + r) * p.so.s + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

template <typename C>
int launch_tc(const Params& p, int B, int H, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S_q + C::BQ - 1) / C::BQ, H, B);
  kernel<<<grid, C::NW * 32, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const Params& p, int B, int H, cudaStream_t stream) {
  if (p.hd <= 64)
    return p.hd == 64 ? launch_tc<TcConfig<64, true>>(p, B, H, stream)
                      : launch_tc<TcConfig<64, false>>(p, B, H, stream);
  return p.hd == 128 ? launch_tc<TcConfig<128, true>>(p, B, H, stream)
                     : launch_tc<TcConfig<128, false>>(p, B, H, stream);
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32; bf16 at hd not a multiple of 16 or above 128)
// ---------------------------------------------------------------------------

template <int HDP, int BK>
constexpr int smem_floats() {
  return HDP * (kBQ + 4) + HDP * (BK + 4) + BK * (HDP + 4) + BK * (kBQ + 4);
}

template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_cudacore_kernel(const Params p) {
  constexpr int CN = BK / 8;    // logit columns per thread
  constexpr int QS = kBQ + 4;   // row strides in floats (16-byte multiples)
  constexpr int KS = BK + 4;
  constexpr int VS = HDP + 4;
  constexpr int PS = kBQ + 4;
  constexpr int DN = HDP / 32;  // float4 output chunks per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [HDP][QS]
  float* Kt = Qt + HDP * QS;   // [HDP][KS]
  float* Vs = Kt + HDP * KS;   // [BK][VS]
  float* Pt = Vs + BK * VS;    // [BK][PS]

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / p.G;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + head * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  T* og = static_cast<T*>(p.o) + b * p.so.b + head * p.so.h;

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int r = i / HDP, d = i - (i / HDP) * HDP;
    float x = 0.f;
    if (q0 + r < p.S_q && d < p.hd) x = to_f(qg[(q0 + r) * p.sq.s + d]);
    Qt[d * QS + r] = x;
  }

  // The kv range this tile reads (module notes: skipping is exact only when
  // no row of the tile is masked everywhere).
  const int q_last = min(q0 + kBQ, p.S_q) - 1;
  int kv_lo = 0, kv_hi = p.S_k;
  if (p.window <= 0 || q_last - p.window + 1 <= p.S_k - 1) {
    if (p.causal) kv_hi = min(p.S_k, q_last + 1);
    if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  }
  const int k_start = (kv_lo / BK) * BK;

  float m[kRM], l[kRM], acc[kRM][DN][4];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int k0 = k_start; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous block's reads of Kt, Vs, Pt are done
    for (int i = tid; i < BK * HDP; i += kThreads) {
      const int c = i / HDP, d = i - (i / HDP) * HDP;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < p.S_k && d < p.hd) {
        kx = to_f(kg[(k0 + c) * p.sk.s + d]);
        vx = to_f(vg[(k0 + c) * p.sv.s + d]);
      }
      Kt[d * KS + c] = kx;
      Vs[c * VS + d] = vx;
    }
    __syncthreads();

    float s[kRM][CN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * QS + rg * kRM]);
      const float qv[kRM] = {qa.x, qa.y, qa.z, qa.w};
      float kv[CN];
#pragma unroll
      for (int j = 0; j < CN; j += 4) {
        const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * KS + cg * CN + j]);
        kv[j] = kb.x;
        kv[j + 1] = kb.y;
        kv[j + 2] = kb.z;
        kv[j + 3] = kb.w;
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qpos = q0 + rg * kRM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + cg * CN + j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = !p.causal || kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        x = ok ? x : kNeg;
        x = kpos < p.S_k ? x : -INFINITY;  // past S_k: never counts
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      *reinterpret_cast<float4*>(&Pt[(cg * CN + j) * PS + rg * kRM]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    const int c_end = min(BK, p.S_k - k0);
#pragma unroll 2
    for (int c = 0; c < c_end; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * PS + rg * kRM]);
      const float pv[kRM] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float4 vb = *reinterpret_cast<const float4*>(&Vs[c * VS + j * 32 + cg * 4]);
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          acc[i][j][0] = fmaf(pv[i], vb.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pv[i], vb.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pv[i], vb.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pv[i], vb.w, acc[i][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = q0 + rg * kRM + i;
    if (r >= p.S_q) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = j * 32 + cg * 4 + e;
        if (d < p.hd) og[r * p.so.s + d] = from_f<T>(acc[i][j][e] / den);
      }
  }
}

template <typename T, int HDP, int BK>
int launch_cudacore(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HDP, BK>() * 4;
  auto kernel = flash_fwd_cudacore_kernel<T, HDP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S_q + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_cudacore(const Params& p, int B, int H, cudaStream_t stream) {
  if (p.hd <= 64) return launch_cudacore<T, 64, 64>(p, B, H, stream);
  if (p.hd <= 128) return launch_cudacore<T, 128, 32>(p, B, H, stream);
  return launch_cudacore<T, 256, 32>(p, B, H, stream);
}

Params make_params(const void* q, const void* k, const void* v, void* o, const int64_t* strides,
                   int G, int S_q, int S_k, int hd, int causal, int window, float softcap,
                   float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.G = G;
  p.S_q = S_q;
  p.S_k = S_k;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// q, o: (B, H, S_q, hd); k, v: (B, H / G, S_k, hd); strides[12] holds the
// (batch, head, seq) element strides of q, k, v, o in that order; window <= 0
// and softcap <= 0 mean none.

// f32 or bf16, hd <= 256.
int flash_attention_fwd_cudacore(const void* q, const void* k, const void* v, void* o,
                                 const int64_t* strides, int B, int H, int G, int S_q, int S_k,
                                 int hd, int causal, int window, float softcap, float scale,
                                 int bf16, void* stream) {
  const Params p = make_params(q, k, v, o, strides, G, S_q, S_k, hd, causal, window, softcap, scale);
  if (B <= 0 || H <= 0 || S_q <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_cudacore<__nv_bfloat16>(p, B, H, s) : dispatch_cudacore<float>(p, B, H, s);
}

// bf16, hd a multiple of 16 up to 128; every pointer and (batch, head, seq)
// stride 16-byte aligned.
int flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                           const int64_t* strides, int B, int H, int G, int S_q, int S_k, int hd,
                           int causal, int window, float softcap, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, strides, G, S_q, S_k, hd, causal, window, softcap, scale);
  if (hd <= 0 || hd > 128 || hd % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S_q <= 0) return static_cast<int>(cudaGetLastError());
  return dispatch_tc(p, B, H, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
