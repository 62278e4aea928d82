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
// row, as zamba2's n_groups = 1 does, without a G-fold copy).  All
// arithmetic in f32; the state S (hd, N) f32 is carried across chunks and,
// when asked, written out after the last one (BH, hd, N).
//
// Beyond the TPU kernel: any S (the last chunk may be ragged: its missing
// steps are zeros with zero log decay, which leave y and S unchanged; no
// 128-lane padding of da), and the final state (the TPU kernel drops it;
// prefill needs it for decode).
//
// Masking: above the diagonal cum_t - cum_s is positive and, at strong
// decays (128 steps of -0.69 reach cum = -89), exp() of it overflows f32.
// The kernel selects 0 there and never evaluates that exp, so no inf * 0.
// At the other end exp(cum_t) and exp(cum_last) go subnormal near e^-88 and
// then to 0; the build has no --use_fast_math, so denormals are kept.
//
// What bounds it on an H100: operations.  The work the function needs per
// chunk of Q steps: the causal half of scores x X, Q (Q + 1) hd, and the
// inter-chunk term and state update, 4 Q N hd, for every row; the causal
// half of C B^T, Q (Q + 1) N, once a b/c row (shared by the heads of a
// batch row in the (B, S, N) form).  At zamba2-1.2b's prefill (BH = 8 * 64,
// S = 512, hd = N = 64, Q = 128) that is 6.5 GFLOP against ~0.15 GB of x,
// y, da, b, c and the state: ~45 operations per byte, and 0.097 ms at the
// card's 67 TFLOP/s f32 rate outside the tensor cores against 0.04 ms at
// its HBM rate.  This first kernel does the products on the CUDA cores in
// f32.  Left for a redesign: C B^T is the same for every head of a batch
// row (64 heads recompute it), half of the (Q, Q) score tile is masked (the
// tiles wholly above the diagonal are skipped, the threads that own them
// idle), and the products fit the tensor cores (mma/wgmma on tf32 or bf16
// tiles).
//
// Design.  The TPU walks a (rows, chunks) grid with the chunk axis
// sequential and the state in VMEM scratch.  Here a block owns one row and
// up to 64 columns of hd (the hd rows of S and the columns of x and y are
// independent, so splitting hd is exact) and loops over the chunks itself.
// Per chunk, with 256 threads and everything in shared memory:
//   * stage X (Q, 64), B^T and C^T (N, Q) as f32, zeros past the chunk's
//     valid steps, past hd and past N;
//   * cumsum of the chunk's da by warp 0 (four steps a lane, a shuffle scan
//     across lanes), then exp(cum_t), exp(cum_last - cum_s), exp(cum_last);
//   * scores G = C B^T * decay in 8 x 8 register tiles from float4 reads of
//     C^T and B^T, one tile a thread, tiles above the diagonal skipped;
//     stored transposed (G^T[s][t]);
//   * y: each thread 8 steps x 4 columns, the intra-chunk sum over s <= its
//     last step from float4 reads of G^T and X, plus exp(cum_t) times C S^T
//     from C^T and S^T; written straight to y;
//   * state: each thread 4 x 4 of S^T (N, 64), decayed and updated from
//     float4 reads of B^T and X.
// Shared memory, f32: X and S^T (Q + N) x 68, B^T and C^T 2 N x (Q + 4),
// G^T Q x (Q + 4), three Q-vectors: 189 KB at Q = 128, N = 64, so dynamic
// shared memory is opted in (one block an SM); a shape that needs more than
// the card gives is refused with the launch's error code.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDT = 64;          // hd columns per block
constexpr int kXS = kDT + 4;     // row stride (floats) of X and S^T
constexpr int kMaxQ = 128;

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
  int S, hd, N, Q;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ inline size_t smem_bytes(int Q, int N) {
  const int Qp = round_up(Q, 8), Np = round_up(N, 4), QS = Qp + 4;
  const size_t floats = size_t(Qp) * kXS + 2 * size_t(Np) * QS + size_t(Qp) * QS +
                        size_t(Np) * kXS + 3 * size_t(Qp) + 4;
  return floats * sizeof(float);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int Qp = round_up(p.Q, 8);
  const int Np = round_up(p.N, 4);
  const int QS = Qp + 4;
  float* Xs = smem;               // [Qp][kXS]
  float* Bt = Xs + Qp * kXS;      // [Np][QS]
  float* Ct = Bt + Np * QS;       // [Np][QS]
  float* Gt = Ct + Np * QS;       // [Qp][QS]  Gt[s][t]
  float* St = Gt + Qp * QS;       // [Np][kXS] St[n][d]
  float* cum = St + Np * kXS;     // [Qp]
  float* ecum = cum + Qp;         // [Qp] exp(cum_t)
  float* wend = ecum + Qp;        // [Qp] exp(cum_last - cum_s)
  float* misc = wend + Qp;        // [0]: exp(cum_last)

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int d0 = blockIdx.y * kDT;
  const int dn = min(kDT, p.hd - d0);
  const int bi = row / p.H, hi = row - (row / p.H) * p.H;
  const TX* xg = static_cast<const TX*>(p.x) + bi * p.xb + hi * p.xh + d0;
  TX* yg = static_cast<TX*>(p.y) + bi * p.yb + hi * p.yh + d0;
  const float* dag = p.da + bi * p.db + hi * p.dh;
  const TB* bg = static_cast<const TB*>(p.b) + int64_t(row / p.G) * p.br;
  const TB* cg = static_cast<const TB*>(p.c) + int64_t(row / p.G) * p.cr;
  const int nt = Qp >> 3;  // 8-step tiles of the chunk

  for (int i = tid; i < Np * kXS; i += kThreads) St[i] = 0.f;

  const int n_chunks = (p.S + p.Q - 1) / p.Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * p.Q;
    const int qn = min(p.Q, p.S - s0);  // valid steps of this chunk

    // Stage the chunk.
    for (int i = tid; i < Qp * kDT; i += kThreads) {
      const int s = i / kDT, d = i % kDT;
      float v = 0.f;
      if (s < qn && d < dn) v = to_f(xg[int64_t(s0 + s) * p.xs + d]);
      Xs[s * kXS + d] = v;
    }
    for (int i = tid; i < Qp * Np; i += kThreads) {
      const int s = i / Np, n = i - (i / Np) * Np;
      float bv = 0.f, cv = 0.f;
      if (s < qn && n < p.N) {
        bv = to_f(bg[int64_t(s0 + s) * p.bs + n]);
        cv = to_f(cg[int64_t(s0 + s) * p.cs + n]);
      }
      Bt[n * QS + s] = bv;
      Ct[n * QS + s] = cv;
    }
    if (tid < Qp) cum[tid] = tid < qn ? dag[int64_t(s0 + tid) * p.ds] : 0.f;
    __syncthreads();

    // Inclusive cumsum of the log decays: four steps a lane of warp 0.
    if (tid < 32) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tid * 4 + e;
        run += t < Qp ? cum[t] : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tid * 4 + e;
        if (t < Qp) cum[t] = excl + v[e];
      }
    }
    __syncthreads();
    const float last = cum[Qp - 1];  // padded steps add 0: the last valid step's
    if (tid < Qp) {
      ecum[tid] = expf(cum[tid]);
      wend[tid] = expf(last - cum[tid]);
    }
    if (tid == 0) misc[0] = expf(last);

    // Scores: G[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0.
    {
      const int ti = tid >> 4, si = tid & 15;
      if (ti < nt && si <= ti) {
        const int t0 = ti * 8, sb = si * 8;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        for (int k = 0; k < Np; ++k) {
          const float4 c0 = *reinterpret_cast<const float4*>(&Ct[k * QS + t0]);
          const float4 c1 = *reinterpret_cast<const float4*>(&Ct[k * QS + t0 + 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bt[k * QS + sb]);
          const float4 b1 = *reinterpret_cast<const float4*>(&Bt[k * QS + sb + 4]);
          const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ct = cum[t0 + i];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = sb + j <= t0 + i ? acc[i][j] * expf(ct - cum[sb + j]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float4*>(&Gt[(sb + j) * QS + t0]) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          *reinterpret_cast<float4*>(&Gt[(sb + j) * QS + t0 + 4]) =
              make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
        }
      }
    }
    __syncthreads();

    // y = G X + exp(cum_t) C S^T: 8 steps x 4 columns a thread.
    {
      const int tg = tid >> 4, dg = tid & 15;
      if (tg < nt) {
        const int t0 = tg * 8, dd = dg * 4;
        float acc[8][4], inter[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = inter[i][j] = 0.f;
        // G^T rows s < t0 + 8 are written (the tiles on and below the
        // diagonal); the terms with s > t are zeros there.
        for (int s = 0; s < t0 + 8; ++s) {
          const float4 g0 = *reinterpret_cast<const float4*>(&Gt[s * QS + t0]);
          const float4 g1 = *reinterpret_cast<const float4*>(&Gt[s * QS + t0 + 4]);
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[s * kXS + dd]);
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], xa[j], acc[i][j]);
        }
        for (int n = 0; n < Np; ++n) {
          const float4 c0 = *reinterpret_cast<const float4*>(&Ct[n * QS + t0]);
          const float4 c1 = *reinterpret_cast<const float4*>(&Ct[n * QS + t0 + 4]);
          const float4 sv = *reinterpret_cast<const float4*>(&St[n * kXS + dd]);
          const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
          const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cv[i], sa[j], inter[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + i;
          if (t >= qn) continue;
          const float e = ecum[t];
          TX* yr = yg + int64_t(s0 + t) * p.ys;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (dd + j < dn) yr[dd + j] = from_f<TX>(fmaf(e, inter[i][j], acc[i][j]));
        }
      }
    }
    __syncthreads();

    // S^T <- exp(cum_last) S^T + B^T (X * exp(cum_last - cum_s)): 4 x 4 a thread.
    {
      const float dec = misc[0];
      for (int idx = tid; idx < (Np >> 2) * (kDT >> 2); idx += kThreads) {
        const int n0 = (idx >> 4) * 4, dd = (idx & 15) * 4;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int s = 0; s < Qp; s += 4) {
          float bv[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 b4 = *reinterpret_cast<const float4*>(&Bt[(n0 + i) * QS + s]);
            bv[i][0] = b4.x;
            bv[i][1] = b4.y;
            bv[i][2] = b4.z;
            bv[i][3] = b4.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 xv = *reinterpret_cast<const float4*>(&Xs[(s + e) * kXS + dd]);
            const float w = wend[s + e];
            const float xa[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i][e], xa[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* sp = reinterpret_cast<float4*>(&St[(n0 + i) * kXS + dd]);
          const float4 old = *sp;
          *sp = make_float4(fmaf(dec, old.x, acc[i][0]), fmaf(dec, old.y, acc[i][1]),
                            fmaf(dec, old.z, acc[i][2]), fmaf(dec, old.w, acc[i][3]));
        }
      }
    }
    __syncthreads();
  }

  if (p.state != nullptr) {
    float* sg = p.state + int64_t(row) * p.hd * p.N;
    for (int i = tid; i < dn * p.N; i += kThreads) {
      const int d = i / p.N, n = i - (i / p.N) * p.N;
      sg[int64_t(d0 + d) * p.N + n] = St[n * kXS + d];
    }
  }
}

template <typename TX, typename TB>
int launch(const Params& p, int BH, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.Q, p.N);
  auto kernel = ssd_scan_kernel<TX, TB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (p.hd + kDT - 1) / kDT);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (B, H, S, hd); da: (B, H, S) f32; b, c: (BH / G, S, N).  strides[13]
// holds the element strides (batch, head, step) of x, y and da, then (row,
// step) of b and c.  Q <= 128.  Returns 0 or a cudaError_t; a shape whose
// shared memory exceeds the card's is refused with that error.
int ssd_scan_fwd(const void* x, const void* da, const void* b, const void* c, void* y,
                 void* state, const int64_t* strides, int BH, int H, int G, int S, int hd,
                 int N, int Q, int x_bf16, int bc_bf16, void* stream) {
  if (BH <= 0 || H <= 0 || G <= 0 || S <= 0 || hd <= 0 || N <= 0 || Q <= 0 || Q > kMaxQ)
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
  p.S = S;
  p.hd = hd;
  p.N = N;
  p.Q = Q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return bc_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, BH, s)
                   : launch<__nv_bfloat16, float>(p, BH, s);
  return bc_bf16 ? launch<float, __nv_bfloat16>(p, BH, s) : launch<float, float>(p, BH, s);
}

}  // extern "C"
