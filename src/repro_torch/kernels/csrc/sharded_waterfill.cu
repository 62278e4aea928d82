// Per-shard water-filling level statistics, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sharded_waterfill.py:72
// waterfill_level_stats (pallas_call :99).  For shard-local scores a (M,) f32,
// in any order, and L candidate levels with their floors (L,) f32, in any
// order:
//
//   n_below[k] = #{a < levels[k]}
//   n_floor[k] = #{a <= floors[k]}
//   mid_sum[k] = sum of a over floors[k] < a < levels[k]
//
// written as one (3, L) f32 array [n_below; n_floor; mid_sum].  Every compare
// with a NaN is false, so NaN scores count nowhere, and +inf scores are never
// below a level.  The sharded K-Vib solve (src/repro_torch/core/solver.py)
// calls it once per ladder pass, five passes a solve, with L = 128, M the
// shard's length and the scores sorted.
//
// What bounds it on an H100: bytes, once the work is a search.  Comparing
// every score with every level (the TPU kernel's way, and this kernel's
// first design) costs M * L pairs of ~6 operations: ~190 operations a byte
// at (M = 10^6, L = 128), far past the ~20 f32 operations a byte where the
// ALUs and not HBM set the pace.  Over a sorted chunk, each level needs two
// binary searches and a difference of prefix sums instead, 2 log2(Q)
// shared-memory steps in place of Q compares; what is left is reading the
// 4 MB of scores once (1.2 µs at 3.35 TB/s) and a kernel's launch and tail.
//
// Design.  The TPU kernel walks one sequential grid over score chunks and
// carries a (3, L) accumulator in VMEM.  Here the blocks run in parallel:
//   * block b stages scores [b * kChunk, (b + 1) * kChunk) in registers, 8 a
//     thread in index order, with 16-byte loads where the chunk is whole and
//     the pointer aligned; entries past M are NaN, which no level counts.
//     2,048 scores a block: in one-off builds, 1,024 and 4,096 were no
//     faster over the solve's sizes taken together, and slower shuffled.  (A single block of at most kSmall scores, as
//     the logreg spec's N = 100, compares each level with every score
//     instead: fewer dependent steps than the rest below);
//   * it checks whether the chunk is non-decreasing (__syncthreads_and over
//     neighbouring pairs; the solve's chunks are) and only if not sorts it:
//     a bitonic network over order-preserving unsigned keys (NaN last),
//     within a thread in registers, across a warp by shuffles, across warps
//     through shared memory;
//   * it keeps the sorted chunk in shared memory and, for each thread's 8
//     entries, the f64 sum of the finite entries before them (a fixed-order
//     block scan): the prefix at any index is that base plus up to 7 values
//     of the thread's run, in f64, so a difference of two prefixes keeps
//     everything f32 keeps, where an f32 prefix would cancel against the
//     chunk's running total;
//   * thread k takes levels k, k + kThreads, ...: hi = #{a < level} and
//     lo = #{a <= floor} by two branch-free binary searches over the next
//     power of two at or above the chunk's length, and the middle sum is
//     prefix[hi] - prefix[lo] (0 when hi <= lo, as when the floor is at or
//     above the level; the count times the value where the middle entries
//     are all equal, so a middle set of zeros sums to exactly 0; -inf where
//     it starts at -inf, which only a NaN floor lets in);
//   * the blocks' (L) partials {n_below, n_floor, mid} are summed in the
//     same launch, in two levels: blocks form groups of about sqrt(n_blocks),
//     at least 16 (so up to 16 blocks sum in one level); the last block of a
//     group to finish (an integer ticket, acquire-release) sums its group's
//     rows in index order, and the last group to finish sums the group rows.
//     Counts add as integers (exact), sums in f64 in a fixed order: no float
//     atomics, so repeated launches are bitwise equal.  With a single block
//     (M <= kChunk) it writes the result itself.
// What holds it back now is that tail, not the bytes: a ticket is a device-
// scope fence and an atomic round trip, and a summing block's reads of rows
// that other SMs just wrote take about as long again each time they wait,
// whether a thread issues its rows one after another (ptxas does, each
// after the previous row's f64 add), in batches, or as cp.async copies to
// shared memory; a level-major layout of the partials made every block's
// release wait on 128 scattered stores instead (one-off phase traces in
// scratch builds; PERF.md §6).
//
// Interface: plain C functions, loaded with ctypes.  They launch on the given
// stream, allocate nothing, and return cudaGetLastError() (0 = ok).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;  // scores a thread
constexpr int kChunk = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kSmall = 256;   // up to this many scores, one block compares them all
constexpr unsigned kFull = 0xffffffffu;

// One level's statistics over a chunk or a group of chunks: 16 bytes.
struct __align__(16) Stats {
  int n_below;
  int n_floor;
  double mid;
};

// Order-preserving unsigned keys of floats, NaN (any sign) the largest.
// -0.0 sorts before +0.0; the two compare equal as floats, which is all the
// searches need.
__device__ __forceinline__ uint32_t to_key(float x) {
  const uint32_t u = x != x ? 0x7fffffffu : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Sort the block's kChunk keys ascending, k[e] holding index t * kPer + e:
// the bitonic network, a stage's pairs (i, i ^ stride) in registers where
// stride < kPer, by shuffles where the partner is in the warp, and through
// `buf` (kChunk words of shared memory) beyond.
__device__ __forceinline__ void bitonic_sort(uint32_t (&k)[kPer], uint32_t* buf) {
  const int t = threadIdx.x;
#pragma unroll
  for (int size = 2; size <= kChunk; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < kPer) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          if (e & stride) continue;
          const bool asc = ((t * kPer + e) & size) == 0;
          const uint32_t lo = min(k[e], k[e + stride]), hi = max(k[e], k[e + stride]);
          k[e] = asc ? lo : hi;
          k[e + stride] = asc ? hi : lo;
        }
        continue;
      }
      // Element e pairs with element e of thread t ^ m; it keeps the smaller
      // key where it is the lower index of an ascending pair or the upper of
      // a descending one.
      const int m = stride / kPer;
      const bool keep_min = ((t & m) == 0) == (((t * kPer) & size) == 0);
      uint32_t o[kPer];
      if (m < 32) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) o[e] = __shfl_xor_sync(kFull, k[e], m);
      } else {
        __syncthreads();  // the previous stage's reads of buf are done
        uint4* mine = reinterpret_cast<uint4*>(buf + t * kPer);
        mine[0] = make_uint4(k[0], k[1], k[2], k[3]);
        mine[1] = make_uint4(k[4], k[5], k[6], k[7]);
        __syncthreads();
        const uint4* theirs = reinterpret_cast<const uint4*>(buf + (t ^ m) * kPer);
        const uint4 a = theirs[0], b = theirs[1];
        o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
        o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) k[e] = keep_min ? min(k[e], o[e]) : max(k[e], o[e]);
    }
  }
}

// How many entries of the sorted chunk s satisfy `pred`, which holds for a
// leading run of it and for nothing after, nor for the NaN padding from
// index `span` (a power of two) on: log2(span) + 1 dependent steps.
template <typename Pred>
__device__ __forceinline__ int count_leading(const float* s, int span, Pred pred) {
  int pos = 0;
#pragma unroll
  for (int step = kChunk / 2; step > 0; step >>= 1) {
    if (step < span) pos += pred(s[pos + step - 1]) ? step : 0;
  }
  return pos + (pred(s[pos]) ? 1 : 0);
}

// The f64 sum of the finite entries s[0, i): the base of thread i / kPer's
// run plus its first i % kPer entries, added in index order.
__device__ __forceinline__ double prefix(const float* s, const double* base, int i) {
  const int t = i / kPer, r = i % kPer;
  double acc = 0.0;
  if (t < kThreads) {
    const float4 a = reinterpret_cast<const float4*>(s + t * kPer)[0];
    const float4 b = reinterpret_cast<const float4*>(s + t * kPer)[1];
    const float v[kPer] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (e < r && isfinite(v[e])) acc += v[e];
    }
  }
  return base[t] + acc;
}

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

// Level k's sums: to *dst, or with dst null into the (3, L) f32 result.
__device__ __forceinline__ void emit(const Stats& v, int k, int L, Stats* dst, float* out) {
  if (dst != nullptr) {
    *dst = v;
  } else {
    out[k] = static_cast<float>(v.n_below);
    out[L + k] = static_cast<float>(v.n_floor);
    out[2 * L + k] = static_cast<float>(v.mid);
  }
}

// Sum rows [0, n_rows) of the (n_rows, L) partials column by column: into
// dst (L Stats) or, with dst null, the (3, L) f32 result.  Where L is under
// kThreads, thread t sums column t % L over rows t / L, t / L + P, ... (P =
// kThreads / L row slices), and the slices are added in order through `red`
// (kThreads Stats of shared memory).  Plain loads, after last_arrival's
// acquire.  Counts in int (they sum to at most M < 2^31), sums in f64; the
// order is fixed.
__device__ void sum_rows(const Stats* rows, int n_rows, int L, Stats* dst, float* out,
                         Stats* red) {
  const int t = threadIdx.x;
  const int slices = L >= kThreads ? 1 : kThreads / L;
  for (int k0 = 0; k0 < L; k0 += kThreads) {
    const int k = k0 + (slices > 1 ? t % L : t), p = slices > 1 ? t / L : 0;
    Stats acc{0, 0, 0.0};
    if (k < L && p < slices) {
      for (int r = p; r < n_rows; r += slices) {
        const Stats v = rows[static_cast<int64_t>(r) * L + k];
        acc.n_below += v.n_below;
        acc.n_floor += v.n_floor;
        acc.mid += v.mid;
      }
    }
    if (slices == 1) {
      if (k < L) emit(acc, k, L, dst == nullptr ? nullptr : dst + k, out);
      continue;
    }
    if (p < slices) red[p * L + k] = acc;
    __syncthreads();
    if (t < L) {
      Stats tot = red[t];
      for (int q = 1; q < slices; ++q) {
        tot.n_below += red[q * L + t].n_below;
        tot.n_floor += red[q * L + t].n_floor;
        tot.mid += red[q * L + t].mid;
      }
      emit(tot, t, L, dst == nullptr ? nullptr : dst + t, out);
    }
  }
}

// Block b: the statistics of scores [b * kChunk, (b + 1) * kChunk) for all
// L levels.  One block: the (3, L) result.  Otherwise its row of `part`
// (n_blocks, L), then the group and final sums (file note); `gpart`
// (n_groups, L) holds the groups' rows, counters[1 + g] is group g's ticket
// counter and counters[0] the groups'.
__global__ void __launch_bounds__(kThreads)
    level_stats_kernel(const float* __restrict__ scores, int64_t M,
                       const float* __restrict__ levels, const float* __restrict__ floors,
                       int L, int group, int n_groups, Stats* __restrict__ part,
                       Stats* __restrict__ gpart, unsigned int* __restrict__ counters,
                       float* __restrict__ out) {
  __shared__ __align__(16) float s[kChunk];
  __shared__ double base[kThreads + 1];
  __shared__ double warp_total[kWarps];
  __shared__ uint32_t first_key[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int n = static_cast<int>(min(static_cast<int64_t>(kChunk), M - start));

  // Thread t's first level and floor, loaded before the scores so that
  // their latency hides behind the scores'.
  const float lv0 = t < L ? levels[t] : 0.f, fl0 = t < L ? floors[t] : 0.f;
  if (gridDim.x == 1 && n <= kSmall) {
    // A few scores (the logreg spec's N = 100): each level against every
    // score, the sum in f32 in index order (a chain of f64 adds was slower
    // than the first design), cheaper than the sort check, the scan and the
    // searches.
    for (int i = t; i < n; i += kThreads) s[i] = scores[i];
    __syncthreads();
    for (int j = t; j < L; j += kThreads) {
      const float lv = j == t ? lv0 : levels[j], fl = j == t ? fl0 : floors[j];
      int nb = 0, nf = 0;
      float mid = 0.f;
      for (int i = 0; i < n; ++i) {
        const float a = s[i];
        nb += a < lv;
        nf += a <= fl;
        if (a < lv && !(a <= fl)) mid += a;
      }
      emit(Stats{nb, nf, mid}, j, L, nullptr, out);
    }
    return;
  }

  uint32_t k[kPer];
  if (n == kChunk && (reinterpret_cast<uintptr_t>(scores) & 15u) == 0) {
    const float4* p = reinterpret_cast<const float4*>(scores + start + t * kPer);
    const float4 a = p[0], b = p[1];
    k[0] = to_key(a.x); k[1] = to_key(a.y); k[2] = to_key(a.z); k[3] = to_key(a.w);
    k[4] = to_key(b.x); k[5] = to_key(b.y); k[6] = to_key(b.z); k[7] = to_key(b.w);
  } else {
    float x[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = t * kPer + e;
      x[e] = i < n ? scores[start + i] : NAN;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) k[e] = to_key(x[e]);
  }

  // Sorted already?  Each thread checks its run and the pair across the
  // boundary to the next thread's.
  if (lane == 0) first_key[warp] = k[0];
  __syncthreads();
  const uint32_t next = __shfl_down_sync(kFull, k[0], 1);
  bool ok = true;
#pragma unroll
  for (int e = 0; e + 1 < kPer; ++e) ok &= k[e] <= k[e + 1];
  if (lane < 31) {
    ok &= k[kPer - 1] <= next;
  } else if (warp + 1 < kWarps) {
    ok &= k[kPer - 1] <= first_key[warp + 1];
  }
  if (!__syncthreads_and(ok)) {
    bitonic_sort(k, reinterpret_cast<uint32_t*>(s));
    __syncthreads();  // every thread's last reads of s as keys are done
  }

  // The sorted chunk into shared memory, and the f64 base of each thread's
  // run: a warp scan of the runs' sums, then the warps' totals in order.
  float x[kPer];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    x[e] = from_key(k[e]);
    if (isfinite(x[e])) run += x[e];
  }
  reinterpret_cast<float4*>(s + t * kPer)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(s + t * kPer)[1] = make_float4(x[4], x[5], x[6], x[7]);
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  double before = 0.0;
  for (int w = 0; w < warp; ++w) before += warp_total[w];
  base[t] = before + excl;
  if (t == kThreads - 1) base[kThreads] = before + incl;
  __syncthreads();

  // The searches span the next power of two at or above n (a whole chunk
  // but in the last block): past n every entry is NaN, which no level counts.
  int span = kChunk;
  while (span / 2 >= n) span /= 2;
  for (int j = t; j < L; j += kThreads) {
    const float lv = j == t ? lv0 : levels[j], fl = j == t ? fl0 : floors[j];
    const int hi = count_leading(s, span, [lv](float a) { return a < lv; });
    const int lo = count_leading(s, span, [fl](float a) { return a <= fl; });
    double mid = 0.0;
    if (hi > lo) {
      const float first = s[lo], last = s[hi - 1];
      if (first == -INFINITY) {
        mid = -INFINITY;
      } else if (first == last) {
        mid = static_cast<double>(hi - lo) * first;
      } else {
        mid = prefix(s, base, hi) - prefix(s, base, lo);
      }
    }
    const Stats v{hi, lo, mid};
    if (gridDim.x == 1) {
      emit(v, j, L, nullptr, out);
    } else {
      part[static_cast<int64_t>(blockIdx.x) * L + j] = v;
    }
  }
  if (gridDim.x == 1) return;

  Stats* red = reinterpret_cast<Stats*>(s);  // kThreads Stats fit in s
  const int g = blockIdx.x / group;
  const int g_rows = min(group, static_cast<int>(gridDim.x) - g * group);
  if (!last_arrival(counters + 1 + g, g_rows)) return;
  const Stats* rows = part + static_cast<int64_t>(g) * group * L;
  if (n_groups == 1) {
    sum_rows(rows, g_rows, L, nullptr, out, red);
    return;
  }
  sum_rows(rows, g_rows, L, gpart + static_cast<int64_t>(g) * L, nullptr, red);
  if (!last_arrival(counters, n_groups)) return;
  sum_rows(gpart, n_groups, L, nullptr, out, red);
}

// The launch's shape for M scores: blocks, blocks a group (about
// sqrt(blocks), and at least kMinGroup, so that up to kMinGroup blocks sum
// in one level), groups.
constexpr int kMinGroup = 16;

struct Grid {
  int64_t blocks;
  int group;
  int groups;
};

Grid grid_for(int64_t M) {
  Grid g;
  g.blocks = (M + kChunk - 1) / kChunk;
  g.group = kMinGroup;
  while (static_cast<int64_t>(g.group) * g.group < g.blocks) ++g.group;
  g.groups = static_cast<int>((g.blocks + g.group - 1) / g.group);
  return g;
}

}  // namespace

extern "C" {

// Bytes of scratch and ticket counters wf_level_stats takes for M scores
// and L levels (none for one block).
long long wf_scratch_bytes(long long M, int L) {
  const Grid g = grid_for(M);
  return g.blocks == 1 ? 0 : (g.blocks + g.groups) * L * static_cast<long long>(sizeof(Stats));
}

long long wf_num_counters(long long M) {
  const Grid g = grid_for(M);
  return g.blocks == 1 ? 0 : g.groups + 1;
}

// scores (M,) f32, levels / floors (L,) f32 -> out (3, L) f32.  scratch:
// wf_scratch_bytes(M, L) bytes, 16-byte aligned.  counters:
// wf_num_counters(M) unsigned ints that are 0 before the launch and are 0
// again after it; launches that may overlap (other streams) need their own.
int wf_level_stats(const float* scores, long long M, const float* levels, const float* floors,
                   int L, void* scratch, unsigned int* counters, float* out, void* stream) {
  if (M < 1 || M > INT32_MAX || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = grid_for(M);
  Stats* part = static_cast<Stats*>(scratch);
  Stats* gpart = part == nullptr ? nullptr : part + g.blocks * L;
  level_stats_kernel<<<static_cast<unsigned int>(g.blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      scores, M, levels, floors, L, g.group, g.groups, part, gpart, counters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
