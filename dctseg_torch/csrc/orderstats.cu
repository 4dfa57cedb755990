// The HD95 order-statistic search, for Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/orderstats.py _count_leq
// (_count_kernel) and the lax.fori_loop of masked_order_stats around it,
// which keeps the whole search one dispatched program.  One launch is one
// pass over a (C, M) float32 value array: for every class c and cut point
// t it counts
//     #{m : values[c, m] <= cut[c, t]}                       (exact, int)
// and then, in search mode, narrows the search as masked_order_stats does.
// Two modes of the one kernel:
//   * count mode (dctseg_torch/ops/orderstats.py count_leq): the cuts come
//     from a (C, T) array and the counts go to a (C, T) int32 output;
//   * search mode (masked_order_stats on CUDA, one launch per pass of the
//     8-ary search, no torch op in between): every block forms the cuts of
//     its class from the (lo, hi) interval of each rank in a small state
//     buffer with the f32 formula of the torch search,
//         cut_s = lo - 1 + floor(s * (hi - lo + 1) / 8),  s = 1..7,
//     and the last block of the class compares the counts with the ranks
//     as int32 and narrows (lo, hi) exactly as the torch search does; the
//     last pass writes hi to the output.
//
// Bound on the H100: bytes.  A pass must read the values once (4*C*M
// bytes).  Design:
//   * a grid of (chunk, class) blocks, one wave over the card, walks the
//     class's row with 16-byte loads (float4), 4 of them in flight a
//     thread, grid-stride;
//   * the cuts sit in registers, padded with NaN (never <=).  Compares are
//     what would bound a pass that tests every value against every cut, so
//     a float4 whose smallest value is above every cut skips them all (in
//     the pooled distances most entries are the masked-out sentinel), and
//     in search mode a value at or below lo - 1 counts for all 7 cuts of a
//     rank with one add and one above hi for none: only the values inside
//     a rank's interval are compared with its cuts;
//   * odd passes walk the array backwards, classes too, so a pass starts
//     on the tail the previous pass left in L2;
//   * each block sums its counters through warp shuffles and shared
//     memory and makes one integer atomicAdd per cut into the workspace:
//     exact in any order; then it takes a ticket, and the block that draws
//     the last one for its class reads the counts and returns them, and
//     the ticket, to zero (nothing is zeroed between launches or calls).
// Rows whose length is not a multiple of 4 take a scalar-load
// instantiation.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxCuts = 32;
constexpr int kFanout = 8;
constexpr int kSteps = kFanout - 1;   // cut points per rank and pass

struct Params {
  const float* values;   // [c][m]
  const float* cuts;     // count mode: [c][t]
  const int* ranks;      // search mode: [c][k], 0-based
  int* counts;           // [c][kMaxCuts], zero between launches
  unsigned* tickets;     // [c], zero between launches
  float* bounds;         // search mode: [c][k][2] lo, hi after each pass
  void* out;             // count mode: int32 [c][t]; search: f32 [c][k]
  long long m;
  int c, t, k, pass, last, narrow;
  float vmax;
};

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// Cut t of class c in search mode: rank t / kSteps, step t % kSteps + 1.
__device__ __forceinline__ float search_cut(const Params& p, int c, int t,
                                            float* lo_out = nullptr,
                                            float* hi_out = nullptr) {
  const int r = t / kSteps;
  float lo = 0.f, hi = p.vmax;
  if (p.pass > 0) {
    lo = p.bounds[((size_t)c * p.k + r) * 2];
    hi = p.bounds[((size_t)c * p.k + r) * 2 + 1];
  }
  if (lo_out) {
    *lo_out = lo;
    *hi_out = hi;
  }
  const float len = hi - lo + 1.f;
  return lo - 1.f + floorf((float)(t % kSteps + 1) * len / (float)kFanout);
}

// One value against G groups of PER cuts.  In a group, a value at or
// below `below` counts for every cut (all[g]) and one above `above` for
// none; only the values in between are compared with each cut.
template <int G, int PER>
__device__ __forceinline__ void count_value(float x, const float* cut,
                                            const float* below,
                                            const float* above, int* cnt,
                                            int* all) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (x <= below[g]) {
      ++all[g];
    } else if (x <= above[g]) {
#pragma unroll
      for (int s = 0; s < PER; ++s) cnt[g * PER + s] += x <= cut[g * PER + s];
    }
  }
}

// Search mode: G ranks of kSteps cuts each, below = lo - 1 <= every cut of
// the rank, above = hi >= every cut.  Count mode: one group of the given
// cuts, below = -inf, above = the largest cut.
template <int G, int PER, bool VEC>
__global__ void __launch_bounds__(kThreads) search_kernel(const Params p) {
  constexpr int TM = G * PER;
  __shared__ int partial[kWarps][TM];
  __shared__ int total[TM];
  __shared__ int is_last;
  const bool rev = p.pass & 1;
  const int c = rev ? p.c - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int tid = threadIdx.x;
  float cut[TM], below[G], above[G];
  int cnt[TM], all[G];
  float cmax = -INFINITY;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    below[g] = -INFINITY;
    above[g] = -INFINITY;
    all[g] = 0;
  }
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    const int g = t / PER;
    if (p.narrow) {
      float lo, hi;
      cut[t] = search_cut(p, c, t, &lo, &hi);
      below[g] = lo - 1.f;
      above[g] = hi;
    } else {
      cut[t] = t < p.t ? p.cuts[(size_t)c * p.t + t] : nan_f32();
      above[g] = fmaxf(above[g], cut[t]);   // NaN cuts never count
    }
    cmax = fmaxf(cmax, above[g]);
    cnt[t] = 0;
  }
  const float* v = p.values + (size_t)c * p.m;
  const long long items = VEC ? p.m / 4 : p.m;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + tid; i0 < items;
       i0 += kUnroll * stride) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      const long long at = rev ? items - 1 - i : i;
      if (i >= items) {
        q[u] = make_float4(nan_f32(), nan_f32(), nan_f32(), nan_f32());
      } else if (VEC) {
        q[u] = __ldg(reinterpret_cast<const float4*>(v) + at);
      } else {
        q[u] = make_float4(__ldg(v + at), nan_f32(), nan_f32(), nan_f32());
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // fminf skips NaN: a float4 whose values are all above every cut
      // (or NaN) counts for nothing
      if (fminf(fminf(q[u].x, q[u].y), fminf(q[u].z, q[u].w)) <= cmax) {
        count_value<G, PER>(q[u].x, cut, below, above, cnt, all);
        count_value<G, PER>(q[u].y, cut, below, above, cnt, all);
        count_value<G, PER>(q[u].z, cut, below, above, cnt, all);
        count_value<G, PER>(q[u].w, cut, below, above, cnt, all);
      }
    }
  }

  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    int s = cnt[t] + all[t / PER];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) partial[warp][t] = s;
  }
  __syncthreads();
  int* counts = p.counts + (size_t)c * kMaxCuts;
  if (tid < p.t) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][tid];
    if (s) atomicAdd(counts + tid, s);
  }
  // Publish the counts, then take a ticket: the block that draws the last
  // one for class c finishes the pass.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(p.tickets + c, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid < p.t) total[tid] = atomicExch(counts + tid, 0);
  if (tid == 0) p.tickets[c] = 0;
  __syncthreads();
  if (!p.narrow) {
    if (tid < p.t) static_cast<int*>(p.out)[(size_t)c * p.t + tid] = total[tid];
    return;
  }
  if (tid < p.k) {
    // answer <= cut_s iff count_s >= rank + 1; the interval becomes
    //   [max(lo, max{cut_s + 1 : not ok_s}), min(hi, min{cut_s : ok_s})]
    float lo, hi;
    search_cut(p, c, tid * kSteps, &lo, &hi);
    const int need = p.ranks[(size_t)c * p.k + tid] + 1;
    float new_lo = lo, new_hi = hi;
    for (int s = 0; s < kSteps; ++s) {
      const float cs = search_cut(p, c, tid * kSteps + s);
      const bool ok = total[tid * kSteps + s] >= need;
      new_lo = fmaxf(new_lo, ok ? lo : cs + 1.f);
      new_hi = fminf(new_hi, ok ? cs : hi);
    }
    if (p.last) {
      static_cast<float*>(p.out)[(size_t)c * p.k + tid] = new_hi;
    } else {
      p.bounds[((size_t)c * p.k + tid) * 2] = new_lo;
      p.bounds[((size_t)c * p.k + tid) * 2 + 1] = new_hi;
    }
  }
}

template <int G, int PER, bool VEC>
cudaError_t launch(Params& p, cudaStream_t stream) {
  const void* k = reinterpret_cast<const void*>(&search_kernel<G, PER, VEC>);
  // one wave of blocks over the card, shared among the classes (the
  // first device's occupancy, read once)
  static const int resident = [k] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
    return per_sm * sms;
  }();
  const long long items = VEC ? p.m / 4 : p.m;
  long long blocks = (items + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long cap = resident / p.c;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  void* args[] = {&p};
  // The tickets return to zero in every launch and each launch's pass
  // number is fixed by its place in the search, so no host state changes
  // from call to call (the pointers aside): a captured search would replay
  // as it ran.
  return cudaLaunchKernel(k, dim3((unsigned)blocks, (unsigned)p.c),
                          dim3(kThreads), args, 0, stream);
}

template <int G, int PER>
cudaError_t launch_vec(Params& p, cudaStream_t stream) {
  const bool vec = p.m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.values) % 16 == 0;
  return vec ? launch<G, PER, true>(p, stream)
             : launch<G, PER, false>(p, stream);
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// args (int64, ops/orderstats.py): values, cuts, ranks, counts, tickets,
// bounds, out, c, m, t, k, pass, last, narrow.  counts and tickets hold
// zeros (the kernel leaves them so).  Search mode: t = 7 * k; pass 0 starts
// from [0, vmax].
extern "C" int dctseg_orderstats(const int64_t* a, float vmax, void* stream) {
  Params p;
  p.values = reinterpret_cast<const float*>(a[0]);
  p.cuts = reinterpret_cast<const float*>(a[1]);
  p.ranks = reinterpret_cast<const int*>(a[2]);
  p.counts = reinterpret_cast<int*>(a[3]);
  p.tickets = reinterpret_cast<unsigned*>(a[4]);
  p.bounds = reinterpret_cast<float*>(a[5]);
  p.out = reinterpret_cast<void*>(a[6]);
  p.c = (int)a[7];
  p.m = a[8];
  p.t = (int)a[9];
  p.k = (int)a[10];
  p.pass = (int)a[11];
  p.last = (int)a[12];
  p.narrow = (int)a[13];
  p.vmax = vmax;
  if (p.c < 1 || p.c > 65535 || p.m < 0 || p.t < 1 || p.t > kMaxCuts ||
      (p.narrow && p.t != kSteps * p.k))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.narrow) {
    switch (p.k) {
      case 1: return launch_vec<1, kSteps>(p, st);
      case 2: return launch_vec<2, kSteps>(p, st);
      case 3: return launch_vec<3, kSteps>(p, st);
      case 4: return launch_vec<4, kSteps>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (p.t <= 8) return launch_vec<1, 8>(p, st);
  if (p.t <= 16) return launch_vec<1, 16>(p, st);
  return launch_vec<1, 32>(p, st);
}
