// Mamba2 SSD chunked scan (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:74 ssd_scan
// (pallas_call :93).  For every row r of BH = B * H (one head of one
// sequence), over chunks of Q steps, with cum the inclusive cumsum of the
// chunk's log decays da:
//
//   y     = (C B^T * exp(cum_t - cum_s) [s <= t]) X + exp(cum_t) C S^T
//   S    <- exp(cum_last) S + (X * exp(cum_last - cum_s))^T B
//
// x (B, H, S, hd) and y in x's dtype (f32 or bf16), any (batch, head, seq)
// strides with hd contiguous, so the model passes its (B, S, H, hd) inputs
// as a view and gets y back in that memory order; da (B, H, S) f32, any
// strides; b, c (R, S, N) in f32 or bf16 with N contiguous, row r reading
// b[r / G] (G = BH / R: G = H shares B and C across the heads of a batch
// row, as zamba2's n_groups = 1 does, without a G-fold copy).  The state S
// (hd, N) f32 is carried across chunks and, when asked, written out after
// the last one (BH, hd, N).
//
// Beyond the TPU kernel: any S (the last chunk may be ragged: its missing
// steps are zeros with zero log decay, which leave y and S unchanged; no
// 128-lane padding of da), and the final state (the TPU kernel drops it;
// prefill needs it for decode).
//
// Masking: above the diagonal cum_t - cum_s is positive and, at strong
// decays (128 steps of -0.69 reach cum = -89), exp() of it overflows f32.
// The kernel selects 0 there and never multiplies an exp of it, so no
// inf * 0.  At the other end exp(cum_t) and exp(cum_last) go subnormal near
// e^-88 and then to 0; the build has no --use_fast_math, so expf keeps
// those denormals.  The decays inside a chunk, exp(cum_t - cum_s), use
// ex2.approx.ftz: one under 2^-126 becomes 0, which moves y by less than
// 2^-126 times a C B^T X term.
//
// What bounds it on an H100: bytes.  The work the function needs per chunk
// of Q steps: the causal half of scores x X, Q (Q + 1) hd, and the
// inter-chunk term and state update, 4 Q N hd, for every row; the causal
// half of C B^T, Q (Q + 1) N, once a b/c row.  At zamba2-1.2b's prefill
// (BH = 8 * 64, S = 512, hd = N = 64, Q = 128) that is 6.5 GFLOP against
// ~0.145 GB of x, y, da, b, c and the state: 0.013 ms at the card's 495
// TFLOP/s TF32 tensor-core rate against 0.043 ms at its HBM rate.
//
// Design (the first CUDA kernel did every product in f32 on the CUDA cores, one
// 189 KB block a row, every head recomputing C B^T).  A block owns one b/c
// row, a group of HG heads that share it and up to 64 columns of hd
// (splitting hd is exact), and walks the chunks in order.  HG is 4, 2 or 1:
// the most that the b/c row has, that shared memory holds (4 for bf16 b/c
// at Q = 128, N = 64; 2 for f32 b/c) and whose grid fills the SMs within
// 90% of one head a block's fill.  Eight warps; every product is an
// mma.sync m16n8k8 on TF32 tiles:
//   * per chunk: B and C are copied once in their own dtype (cp.async), the
//     chunk's da of the HG heads is summed (one warp a head, a shuffle
//     scan) and exp(cum_t), exp(cum_last - cum_s), exp(cum_last) kept; then
//     C B^T is computed once for the group, only the 16 x 8 tiles on or
//     below the diagonal, nine a warp side by side, into a packed triangle
//     of row tiles;
//   * per head: y = exp(cum_t) (C S^T) + G X with G = C B^T * exp(cum_t -
//     cum_s) [s <= t] formed in registers from the triangle; warp w owns
//     the row tiles w % 4 and 7 - w % 4 (9 of the 18 score-tile columns a
//     pair, so no warp waits on another's triangle) and half of the 64
//     columns; then S^T <- exp(cum_last) S^T + B^T (X * exp(cum_last -
//     cum_s)), a column tile of S^T a warp;
//   * precision: bf16 values are exact in TF32, so C B^T of bf16 b/c is one
//     mma a tile; every product with an f32 operand takes the split
//     a = hi + lo (hi = a truncated to TF32, lo = a - hi truncated, an
//     integer mask each) and three mma's (lo*hi + hi*lo into one
//     accumulator, hi*hi into another; two when the other operand is
//     bf16), which keeps f32 accuracy (the plain version within 1e-4 of the
//     largest value, the tests' f32 bound; plain TF32 misses it);
//   * the k order inside an m16n8k8 is permuted (k = tq <-> 2 tq, k = tq + 4
//     <-> 2 tq + 1), so a score tile in the accumulator layout is already
//     the A operand of the next product, and operand pairs load as one
//     8-byte (f32) or 4-byte (bf16) word;
//   * no branch sits between a k-step's shared loads and its mma's (the
//     G X loop is split where the pair's first row tile ends; tiles past
//     the chunk read tile 0 and are not stored), so ptxas can hoist them;
//   * X of the next head (or the next chunk's first head) is copied with
//     cp.async into a second buffer while the current head computes (f32 x
//     with 16-byte aligned rows; other x is staged synchronously).
// Shared memory at Q = 128, N = 64, HG = 4, bf16 b/c: the four states S^T,
// two X buffers, the C B^T triangle, B and C, the decays: 218 KB, one block
// an SM.  What is left: eight warps an SM issue well under one instruction
// a cycle, so latency (shared loads, the split, the mma chain) holds it
// rather than the tensor cores; each G element is formed by the two warps
// that share its rows; the split triples the mma's of the f32 products;
// the chunks run in order within a block.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDT = 64;          // hd columns per block
constexpr int kXS = kDT + 4;     // row stride (floats) of X and S^T: 4 mod 32
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;       // the state update keeps N / 16 tiles a warp
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* x;
  const float* da;
  const void* b;
  const void* c;
  void* y;
  float* state;                // (BH, hd, N) or null
  int64_t xb, xh, xs;          // element strides: batch, head, step (hd contiguous)
  int64_t yb, yh, ys;
  int64_t db, dh, ds;
  int64_t br, bs, cr, cs;      // b, c: row, step (N contiguous)
  int H;                       // row r is (r / H, r % H) of x, da, y
  int G;                       // row r reads b[r / G], c[r / G]
  int HG;                      // heads a block (a b/c row's last group may be short)
  int S, hd, N, Q;
  int x_async;                 // f32 x with 16-byte aligned rows: cp.async staging
  int bc_async;                // b and c with 16-byte aligned rows: cp.async staging
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename TB>
__host__ __device__ inline int bc_stride(int Np) {
  // B and C rows: 4 words mod 32 for bf16 pairs, 4 floats past N for f32.
  return Np + (std::is_same<TB, __nv_bfloat16>::value ? 8 : 4);
}

// Floats of the packed C B^T triangle: row tile r (16 rows) holds columns
// [0, 16 (r + 1)) with a row stride of 16 (r + 1) + 8, starting at
// 128 r (r + 2).
__host__ __device__ inline int tri_offset(int r) { return 128 * r * (r + 2); }

template <typename TB>
__host__ inline size_t smem_bytes(int Q, int N, int HG) {
  const int Qp = round_up(Q, 16), Np = round_up(N, 16), nrt = Qp / 16;
  const size_t floats = size_t(HG) * Np * kXS + 2 * size_t(Qp) * kXS + tri_offset(nrt) +
                        3 * size_t(HG) * Qp + 4;
  return floats * sizeof(float) + 2 * size_t(Qp) * bc_stride<TB>(Np) * sizeof(TB);
}

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

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// TF32 by truncation: the f32 pattern with its 13 low mantissa bits
// cleared (an integer AND; cvt.rna.tf32.f32 runs at a fraction of the ALU
// rate and would dominate the split).
__device__ __forceinline__ uint32_t tf32(float v) { return __float_as_uint(v) & 0xffffe000u; }

// v = hi + lo + r with hi = tf32(v), lo = tf32(v - hi) (v - hi is exact in
// f32) and |r| < 2^-20 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// 2^v, flushing results below 2^-126 to 0 (a decay that small adds
// nothing at f32's precision; without .ftz the instruction takes four more
// for its subnormal range).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Not volatile: ptxas may interleave independent accumulators' mma's.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An m16n8k8 operand in both parts; `exact` operands (bf16 values) have
// lo = 0 and skip the mma's that would read it.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool kExactA>
__device__ __forceinline__ void set_a(FragA& f, float a0, float a1, float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kExactA) f.hi[i] = __float_as_uint(v[i]);
    else split(v[i], f.hi[i], f.lo[i]);
  }
}

template <bool kExactB>
__device__ __forceinline__ void set_b(FragB& f, float b0, float b1) {
  if (kExactB) {
    f.hi[0] = __float_as_uint(b0);
    f.hi[1] = __float_as_uint(b1);
  } else {
    split(b0, f.hi[0], f.lo[0]);
    split(b1, f.hi[1], f.lo[1]);
  }
}

// acc[i] + corr[i] += a b[i] in f32 accuracy for kN accumulators: the
// cross terms lo*hi and hi*lo into corr, hi*hi into acc (two dependent
// chains where one would be twice as long), each term issued for all kN
// before the next.
template <bool kExactA, bool kExactB, int kN>
__device__ __forceinline__ void mma3(float (&acc)[kN][4], float (&corr)[kN][4], const FragA& a,
                                     const FragB (&b)[kN]) {
  if (!kExactA) {
#pragma unroll
    for (int i = 0; i < kN; ++i) mma(corr[i], a.lo, b[i].hi);
  }
  if (!kExactB) {
#pragma unroll
    for (int i = 0; i < kN; ++i) mma(corr[i], a.hi, b[i].lo);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) mma(acc[i], a.hi, b[i].hi);
}

// The same with one B operand and kN A operands.
template <bool kExactA, bool kExactB, int kN>
__device__ __forceinline__ void mma3(float (&acc)[kN][4], float (&corr)[kN][4],
                                     const FragA (&a)[kN], const FragB& b) {
  if (!kExactA) {
#pragma unroll
    for (int i = 0; i < kN; ++i) mma(corr[i], a[i].lo, b.hi);
  }
  if (!kExactB) {
#pragma unroll
    for (int i = 0; i < kN; ++i) mma(corr[i], a[i].hi, b.lo);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) mma(acc[i], a[i].hi, b.hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

// X's B operands for the k-step at row s (rows s and s + 1: the permuted k
// order) and the warp's four column tiles from column d.
__device__ __forceinline__ void load_x(FragB (&xb)[4], const float* X, int s, int d) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) set_b<false>(xb[nt], X[s * kXS + d + 8 * nt], X[(s + 1) * kXS + d + 8 * nt]);
}

// acc + corr += G X for row tile r (rows 16 r..) over the k-step of columns
// 8 j..: G = C B^T * 2^((c_t - c_s) log2 e) [s <= t] from the triangle, c
// the cumsum (lt0, lt1 at the thread's rows t, t + 8; ls at its columns s,
// s + 1).
__device__ __forceinline__ void gx_tile(float (&acc)[4][4], float (&corr)[4][4], const FragB (&xb)[4],
                                        const float* tri, int r, int j, int g, int tq, float lt0,
                                        float lt1, float2 ls) {
  const float* tr = tri + tri_offset(r) + 8 * j + 2 * tq;
  const int W = 16 * (r + 1) + 8;
  const float2 u = ld2(tr + g * W), l = ld2(tr + (g + 8) * W);
  const int s = 8 * j + 2 * tq, t = 16 * r + g;
  FragA a;
  set_a<false>(a, s <= t ? u.x * ex2((lt0 - ls.x) * kLog2e) : 0.f,
               s <= t + 8 ? l.x * ex2((lt1 - ls.x) * kLog2e) : 0.f,
               s + 1 <= t ? u.y * ex2((lt0 - ls.y) * kLog2e) : 0.f,
               s + 1 <= t + 8 ? l.y * ex2((lt1 - ls.y) * kLog2e) : 0.f);
  mma3<false, false, 4>(acc, corr, a, xb);
}

// X rows [s0, s0 + qn) of one head, columns [0, dn) of the block's tile,
// into dst [Qp][kXS] as f32, zeros elsewhere.  Then one commit (empty on
// the synchronous path), so every thread has one group per staging.
template <typename TX>
__device__ __forceinline__ void stage_x(float* dst, const TX* src, int64_t xs, int qn, int dn,
                                        int Qp, bool async) {
  if (std::is_same<TX, float>::value && async) {
    for (int i = threadIdx.x; i < Qp * (kDT / 4); i += kThreads) {
      const int s = i / (kDT / 4), k = i % (kDT / 4);
      const int bytes = s < qn ? max(0, min(4, dn - 4 * k)) * 4 : 0;
      const TX* g = bytes ? src + int64_t(s) * xs + 4 * k : src;
      cp_async16(dst + s * kXS + 4 * k, g, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < Qp * kDT; i += kThreads) {
      const int s = i / kDT, d = i % kDT;
      dst[s * kXS + d] = s < qn && d < dn ? to_f(src[int64_t(s) * xs + d]) : 0.f;
    }
  }
  cp_async_commit();
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Params p) {
  constexpr bool kBcExact = std::is_same<TB, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  const int Qp = round_up(p.Q, 16), Np = round_up(p.N, 16), nrt = Qp / 16;
  const int HG = p.HG, BCS = bc_stride<TB>(Np);
  float* St = smem;                           // [HG][Np][kXS]  S^T[n][d] of each head
  float* Xs = St + HG * Np * kXS;             // [2][Qp][kXS]
  float* tri = Xs + 2 * Qp * kXS;             // C B^T row tiles on and below the diagonal
  float* cum = tri + tri_offset(nrt);         // [HG][Qp] cumsum of da
  float* ecum = cum + HG * Qp;                // [HG][Qp] exp(cum_t)
  float* wend = ecum + HG * Qp;               // [HG][Qp] exp(cum_last - cum_s)
  float* elast = wend + HG * Qp;              // [HG] exp(cum_last)
  TB* Bs = reinterpret_cast<TB*>(elast + 4);  // [Qp][BCS]
  TB* Cs = Bs + Qp * BCS;                     // [Qp][BCS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ngroups = (p.G + HG - 1) / HG;
  const int rb = blockIdx.x / ngroups;
  const int row0 = rb * p.G + (blockIdx.x - rb * ngroups) * HG;
  const int nh = min(HG, p.G - (blockIdx.x - rb * ngroups) * HG);
  const int d0 = blockIdx.y * kDT;
  const int dn = min(kDT, p.hd - d0);
  const TB* bg = static_cast<const TB*>(p.b) + int64_t(rb) * p.br;
  const TB* cg = static_cast<const TB*>(p.c) + int64_t(rb) * p.cr;
  auto xg = [&](int h) {
    const int r = row0 + h;
    return static_cast<const TX*>(p.x) + (r / p.H) * p.xb + (r % p.H) * p.xh + d0;
  };
  const bool async = p.x_async != 0;

  for (int i = tid; i < HG * Np * kXS; i += kThreads) St[i] = 0.f;

  // Warp roles in the per-head products.
  const int pr = warp & 3, dh = warp >> 2;
  const int rt[2] = {pr, nrt - 1 - pr};                 // row tiles of the score pair
  const bool rv[2] = {pr < nrt, nrt - 1 - pr > pr};     // each valid (distinct, inside Qp)

  const int n_chunks = (p.S + p.Q - 1) / p.Q;
  int buf = 0;
  stage_x<TX>(Xs, xg(0), p.xs, min(p.Q, p.S), dn, Qp, async);

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * p.Q;
    const int qn = min(p.Q, p.S - s0);  // valid steps of this chunk

    // Stage B and C of the chunk (16-byte cp.async where the rows allow,
    // all of a thread's copies in flight at once), and the heads' log
    // decays.
    if (p.bc_async) {
      constexpr int V = 16 / sizeof(TB);
      const int nv = Np / V;
      for (int i = tid; i < Qp * nv; i += kThreads) {
        const int s = i / nv, k = i - (i / nv) * nv;
        const int bytes = s < qn ? max(0, min(V, p.N - V * k)) * int(sizeof(TB)) : 0;
        const int64_t ob = bytes ? int64_t(s0 + s) * p.bs + V * k : 0;
        const int64_t oc = bytes ? int64_t(s0 + s) * p.cs + V * k : 0;
        cp_async16(Bs + s * BCS + V * k, bg + ob, bytes);
        cp_async16(Cs + s * BCS + V * k, cg + oc, bytes);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < Qp * Np; i += kThreads) {
        const int s = i / Np, n = i - (i / Np) * Np;
        TB bv = from_f<TB>(0.f), cv = from_f<TB>(0.f);
        if (s < qn && n < p.N) {
          bv = bg[int64_t(s0 + s) * p.bs + n];
          cv = cg[int64_t(s0 + s) * p.cs + n];
        }
        Bs[s * BCS + n] = bv;
        Cs[s * BCS + n] = cv;
      }
    }
    for (int i = tid; i < nh * Qp; i += kThreads) {
      const int h = i / Qp, t = i - (i / Qp) * Qp;
      const int r = row0 + h;
      cum[i] = t < qn ? p.da[(r / p.H) * p.db + (r % p.H) * p.dh + int64_t(s0 + t) * p.ds] : 0.f;
    }
    cp_async_wait0();  // B and C, and the first head's X
    __syncthreads();

    // Inclusive cumsum of each head's log decays (warp h, four steps a
    // lane, a shuffle scan across lanes) and the decays it gives.
    if (warp < nh) {
      float* c = cum + warp * Qp;
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        run += t < Qp ? c[t] : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float last = __shfl_sync(0xffffffffu, incl, 31);  // padded steps add 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        if (t < Qp) {
          const float ct = excl + v[e];
          c[t] = ct;
          ecum[warp * Qp + t] = expf(ct);
          wend[warp * Qp + t] = expf(last - ct);
        }
      }
      if (lane == 0) elast[warp] = expf(last);
    }

    // C B^T once for the group: the 16 x 8 tiles on and below the diagonal,
    // dealt round the warps (tile i of the nrt (nrt + 1) in row order to
    // warp i % 8), a warp's tiles accumulating side by side.  Tile (r, j):
    // rows 16 r.., columns 8 j...
    {
      constexpr int kTiles = (kMaxQ / 16) * (kMaxQ / 16 + 1) / kWarps;  // 9 a warp at most
      const int n_tiles = nrt * (nrt + 1);
      int tr_[kTiles], tj[kTiles];  // past n_tiles: tile 0 again, computed and not stored
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        const int t = i * kWarps + warp < n_tiles ? i * kWarps + warp : 0;
        int r = 0;
        while ((r + 1) * (r + 2) <= t) ++r;  // tiles before row tile r: r (r + 1)
        tr_[i] = r;
        tj[i] = t - r * (r + 1);
      }
      float acc[kTiles][4];
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      for (int k0 = 0; k0 < Np; k0 += 8) {
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          const TB* cr = Cs + (16 * tr_[i] + g) * BCS + k0 + 2 * tq;
          const float2 cu = ld2(cr), cl = ld2(cr + 8 * BCS);
          const float2 bb = ld2(Bs + (8 * tj[i] + g) * BCS + k0 + 2 * tq);
          FragA a;
          FragB b;
          set_a<kBcExact>(a, cu.x, cl.x, cu.y, cl.y);
          set_b<kBcExact>(b, bb.x, bb.y);
          if (!kBcExact) {
            mma(acc[i], a.lo, b.hi);
            mma(acc[i], a.hi, b.lo);
          }
          mma(acc[i], a.hi, b.hi);
        }
      }
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        if (i * kWarps + warp >= n_tiles) break;
        const int r = tr_[i], j = tj[i];
        float* tr = tri + tri_offset(r) + 8 * j + 2 * tq;
        const int W = 16 * (r + 1) + 8;
        *reinterpret_cast<float2*>(tr + g * W) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(tr + (g + 8) * W) = make_float2(acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();

    for (int h = 0; h < nh; ++h) {
      // Next X into the other buffer, then wait for this head's.
      if (h + 1 < nh) {
        stage_x<TX>(Xs + (buf ^ 1) * Qp * kXS, xg(h + 1) + int64_t(s0) * p.xs, p.xs, qn, dn, Qp,
                    async);
      } else if (ch + 1 < n_chunks) {
        stage_x<TX>(Xs + (buf ^ 1) * Qp * kXS, xg(0) + int64_t(s0 + p.Q) * p.xs, p.xs,
                    min(p.Q, p.S - s0 - p.Q), dn, Qp, async);
      } else {
        cp_async_commit();
      }
      cp_async_wait1();
      __syncthreads();

      const float* X = Xs + buf * Qp * kXS;
      const float* S = St + h * Np * kXS;
      const float* lc = cum + h * Qp;

      // y rows of the warp's two row tiles, columns 32 dh .. 32 dh + 31.
      {
        float acc[2][4][4], corr[2][4][4];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[ri][nt][e] = corr[ri][nt][e] = 0.f;

        // Inter-chunk term C S^T (k = n).
        for (int k0 = 0; k0 < Np; k0 += 8) {
          FragB sb[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int d = 8 * (4 * dh + nt) + g;
            set_b<false>(sb[nt], S[(k0 + 2 * tq) * kXS + d], S[(k0 + 2 * tq + 1) * kXS + d]);
          }
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {  // a tile past Qp reads tile 0 and is not stored
            const TB* cr = Cs + (16 * (rv[ri] ? rt[ri] : 0) + g) * BCS + k0 + 2 * tq;
            const float2 cu = ld2(cr), cl = ld2(cr + 8 * BCS);
            FragA a;
            set_a<kBcExact>(a, cu.x, cl.x, cu.y, cl.y);
            mma3<kBcExact, false, 4>(acc[ri], corr[ri], a, sb);
          }
        }
        float ct[2][2];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const int t = 16 * rt[ri] + g;
          ct[ri][0] = rv[ri] ? lc[t] : 0.f;
          ct[ri][1] = rv[ri] ? lc[t + 8] : 0.f;
          const float e0 = rv[ri] ? ecum[h * Qp + t] : 0.f;
          const float e1 = rv[ri] ? ecum[h * Qp + t + 8] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            acc[ri][nt][0] *= e0;
            acc[ri][nt][1] *= e0;
            acc[ri][nt][2] *= e1;
            acc[ri][nt][3] *= e1;
            corr[ri][nt][0] *= e0;
            corr[ri][nt][1] *= e0;
            corr[ri][nt][2] *= e1;
            corr[ri][nt][3] *= e1;
          }
        }

        // Intra-chunk term G X (k = s), G formed from the triangle: both row
        // tiles up to the first one's diagonal, then the second alone, so no
        // branch sits between a k-step's loads and its mma's.
        const int d_w = 32 * dh + g;
        if (rv[1]) {
          int j = 0;
          for (; j <= 2 * rt[0] + 1; ++j) {
            FragB xb[4];
            load_x(xb, X, 8 * j + 2 * tq, d_w);
            const float2 ls = ld2(lc + 8 * j + 2 * tq);
            gx_tile(acc[0], corr[0], xb, tri, rt[0], j, g, tq, ct[0][0], ct[0][1], ls);
            gx_tile(acc[1], corr[1], xb, tri, rt[1], j, g, tq, ct[1][0], ct[1][1], ls);
          }
          for (; j <= 2 * rt[1] + 1; ++j) {
            FragB xb[4];
            load_x(xb, X, 8 * j + 2 * tq, d_w);
            const float2 ls = ld2(lc + 8 * j + 2 * tq);
            gx_tile(acc[1], corr[1], xb, tri, rt[1], j, g, tq, ct[1][0], ct[1][1], ls);
          }
        } else if (rv[0]) {
          for (int j = 0; j <= 2 * rt[0] + 1; ++j) {
            FragB xb[4];
            load_x(xb, X, 8 * j + 2 * tq, d_w);
            const float2 ls = ld2(lc + 8 * j + 2 * tq);
            gx_tile(acc[0], corr[0], xb, tri, rt[0], j, g, tq, ct[0][0], ct[0][1], ls);
          }
        }

        TX* yh = static_cast<TX*>(p.y) + ((row0 + h) / p.H) * p.yb + ((row0 + h) % p.H) * p.yh + d0;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          if (!rv[ri]) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = 16 * rt[ri] + g + 8 * half;
            if (t >= qn) continue;
            TX* yr = yh + int64_t(s0 + t) * p.ys;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int d = 8 * (4 * dh + nt) + 2 * tq;
              if (d < dn) yr[d] = from_f<TX>(acc[ri][nt][2 * half] + corr[ri][nt][2 * half]);
              if (d + 1 < dn)
                yr[d + 1] = from_f<TX>(acc[ri][nt][2 * half + 1] + corr[ri][nt][2 * half + 1]);
            }
          }
        }
      }

      // State update B^T (X * exp(cum_last - cum_s)) (k = s): the warp's
      // column tile d = 8 warp .., all N / 16 row tiles of S^T.
      float sacc[kMaxN / 64][4][4], scorr[kMaxN / 64][4][4];  // row tile 4 q + i of S^T: [q][i]
#pragma unroll
      for (int q = 0; q < kMaxN / 64; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[q][i][e] = scorr[q][i][e] = 0.f;
      {
        const float* wh = wend + h * Qp;
        const int nmt = Np / 16;
        for (int k0 = 0; k0 < Qp; k0 += 8) {
          const int s = k0 + 2 * tq;
          FragB xb;
          set_b<false>(xb, X[s * kXS + 8 * warp + g] * wh[s], X[(s + 1) * kXS + 8 * warp + g] * wh[s + 1]);
          const TB* b0 = Bs + s * BCS + g;
          // Four row tiles at a time (tiles past N / 16 multiply zeros).
#pragma unroll
          for (int q = 0; q < kMaxN / 64; ++q) {
            if (4 * q >= nmt) break;
            FragA a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = 16 * (4 * q + i);
              if (4 * q + i < nmt)
                set_a<kBcExact>(a[i], to_f(b0[m]), to_f(b0[m + 8]), to_f(b0[BCS + m]),
                                to_f(b0[BCS + m + 8]));
              else
#pragma unroll
                for (int e = 0; e < 4; ++e) a[i].hi[e] = a[i].lo[e] = 0u;
            }
            mma3<kBcExact, false, 4>(sacc[q], scorr[q], a, xb);
          }
        }
      }
      __syncthreads();  // every warp is done reading S (and this X)
      {
        float* Sw = St + h * Np * kXS;
        const float dec = elast[h];
        const int nmt = Np / 16;
#pragma unroll
        for (int mt = 0; mt < kMaxN / 16; ++mt) {
          if (mt >= nmt) break;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* sp = reinterpret_cast<float2*>(Sw + (16 * mt + g + 8 * half) * kXS + 8 * warp + 2 * tq);
            const float2 old = *sp;
            const float* u = sacc[mt / 4][mt % 4];
            const float* v = scorr[mt / 4][mt % 4];
            *sp = make_float2(fmaf(dec, old.x, u[2 * half] + v[2 * half]),
                              fmaf(dec, old.y, u[2 * half + 1] + v[2 * half + 1]));
          }
        }
      }
      buf ^= 1;
    }
  }
  cp_async_wait0();
  __syncthreads();

  if (p.state != nullptr) {
    for (int h = 0; h < nh; ++h) {
      float* sg = p.state + int64_t(row0 + h) * p.hd * p.N;
      const float* Sh = St + h * Np * kXS;
      for (int i = tid; i < dn * p.N; i += kThreads) {
        const int d = i / p.N, n = i - (i / p.N) * p.N;
        sg[int64_t(d0 + d) * p.N + n] = Sh[n * kXS + d];
      }
    }
  }
}

template <typename TX, typename TB>
int launch(Params& p, int R, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Heads a block: of 4, 2 and 1, those that the b/c row has and shared
  // memory holds; of them the most heads whose grid fills the SMs' waves
  // (one block an SM) within 90% of one head a block's fill.
  int nsm = 1;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ndt = (p.hd + kDT - 1) / kDT;
  auto fill = [&](int hg) {
    const int64_t blocks = int64_t(R) * ((p.G + hg - 1) / hg) * ndt;
    return double(blocks) / double((blocks + nsm - 1) / nsm * nsm);
  };
  int hg = 1;
  for (const int cand : {4, 2}) {
    if (cand <= p.G && smem_bytes<TB>(p.Q, p.N, cand) <= size_t(max_smem) &&
        fill(cand) >= 0.9 * fill(1)) {
      hg = cand;
      break;
    }
  }
  p.HG = hg;
  const size_t bytes = smem_bytes<TB>(p.Q, p.N, hg);
  auto kernel = ssd_scan_kernel<TX, TB>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = int64_t(R) * ((p.G + hg - 1) / hg);
  if (blocks >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), ndt);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (B, H, S, hd); da: (B, H, S) f32; b, c: (BH / G, S, N).  strides[13]
// holds the element strides (batch, head, step) of x, y and da, then (row,
// step) of b and c.  Q <= 128, N <= 128.  Returns 0 or a cudaError_t; a
// shape whose shared memory exceeds the card's is refused with that error.
int ssd_scan_fwd(const void* x, const void* da, const void* b, const void* c, void* y,
                 void* state, const int64_t* strides, int BH, int H, int G, int S, int hd,
                 int N, int Q, int x_bf16, int bc_bf16, void* stream) {
  if (BH <= 0 || H <= 0 || G <= 0 || BH % G || S <= 0 || hd <= 0 || N <= 0 || N > kMaxN ||
      Q <= 0 || Q > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.da = static_cast<const float*>(da);
  p.b = b;
  p.c = c;
  p.y = y;
  p.state = static_cast<float*>(state);
  p.xb = strides[0];
  p.xh = strides[1];
  p.xs = strides[2];
  p.yb = strides[3];
  p.yh = strides[4];
  p.ys = strides[5];
  p.db = strides[6];
  p.dh = strides[7];
  p.ds = strides[8];
  p.br = strides[9];
  p.bs = strides[10];
  p.cr = strides[11];
  p.cs = strides[12];
  p.H = H;
  p.G = G;
  p.HG = 1;
  p.S = S;
  p.hd = hd;
  p.N = N;
  p.Q = Q;
  p.x_async = !x_bf16 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 && p.xb % 4 == 0 &&
              p.xh % 4 == 0 && p.xs % 4 == 0;
  const int vb = 16 / (bc_bf16 ? 2 : 4);  // elements in 16 bytes of b and c
  p.bc_async = (reinterpret_cast<uintptr_t>(b) & 15) == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0 &&
               p.br % vb == 0 && p.bs % vb == 0 && p.cr % vb == 0 && p.cs % vb == 0;
  const int R = BH / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return bc_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, R, s)
                   : launch<__nv_bfloat16, float>(p, R, s);
  return bc_bf16 ? launch<float, __nv_bfloat16>(p, R, s)
                 : launch<float, float>(p, R, s);
}

}  // extern "C"
