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
// What bounds it on an H100: operations.  At the smollm-360m prefill shape
// (B=8, H=15, S=512, hd=64, causal) the causal half is ~4.0 GFLOP against
// ~21 MB of q, k, v and out: ~190 operations per byte, above the ~150 the
// card's bf16 tensor cores need per byte of HBM.  This first kernel does its
// products on the CUDA cores in f32 (no mma/wgmma, no TMA), so it runs far
// from that bound; the design is the simple one that is right.
//
// Design.  The TPU kernel walks a (heads, q blocks, kv blocks) grid with the
// kv axis sequential, carrying acc/m/l in VMEM scratch.  Here a block owns
// one (batch, head, 64-row query tile) and loops over the kv blocks itself:
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
//   * kv blocks wholly above the causal diagonal or wholly outside the
//     window are skipped.  This is exact when every row of the tile keeps a
//     valid key: a fully masked block before the row's first valid one is
//     wiped by correction = exp(-2.38e38 - m) = 0, and one after it adds
//     exp(-2.38e38 - m) = 0.  When some row of the tile is masked
//     everywhere (possible only with a window and S_q > S_k + window - 1),
//     the tile walks every kv block, as the TPU kernel does.
// Shared memory: 68 KB (hd <= 64, 64-key blocks: three blocks an SM), 77 KB
// (hd <= 128, 32-key blocks: two an SM; with 64-key blocks it took 118 KB,
// one 4-warp block an SM, and ran 2x slower), 145 KB (hd <= 256, 32-key
// blocks), so dynamic shared memory is opted in per variant.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (0 = ok).

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

template <int HDP, int BK>
constexpr int smem_floats() {
  return HDP * (kBQ + 4) + HDP * (BK + 4) + BK * (HDP + 4) + BK * (kBQ + 4);
}

template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
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
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HDP, BK>() * 4;
  auto kernel = flash_fwd_kernel<T, HDP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S_q + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, int H, cudaStream_t stream) {
  if (p.hd <= 64) return launch<T, 64, 64>(p, B, H, stream);
  if (p.hd <= 128) return launch<T, 128, 32>(p, B, H, stream);
  return launch<T, 256, 32>(p, B, H, stream);
}

}  // namespace

extern "C" {

// q, o: (B, H, S_q, hd); k, v: (B, H / G, S_k, hd); strides[12] holds the
// (batch, head, seq) element strides of q, k, v, o in that order.  hd <= 256;
// window <= 0 and softcap <= 0 mean none.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const int64_t* strides, int B, int H, int G, int S_q, int S_k, int hd,
                        int causal, int window, float softcap, float scale, int bf16,
                        void* stream) {
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
  if (B <= 0 || H <= 0 || S_q <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(p, B, H, s) : dispatch<float>(p, B, H, s);
}

}  // extern "C"
