// Fused InstanceNorm + activation (+ residual), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/fusednorm.py
// fused_instance_norm_act (stats pass _stats_kernel, apply pass
// _apply_kernel / _apply_res_kernel) and computes what that kernel
// computes: per (sample, fine channel) f32 sum and sum of squares over all
// spatial positions, var = max(E[x^2] - mean^2, 0), a = 1/sqrt(var + eps),
// b = -mean * a; then y = act(x * a + b) in f32, cast to the output dtype,
// then + residual in the output dtype.  The pre-activation residual route
// (MONAI's UnetResBlock: lrelu(IN(conv2(h)) + r)) adds the residual before
// the activation instead, y = act(x * a + b + r) in f32, cast once; the
// caller asks for it with kResidualBefore in the act argument, and it has
// kernels of its own (RES = 2), so the other routes' kernels and their
// occupancy, and hence their plans, are as they were.  Lane o*F + c of a C = O*F wide
// channel axis belongs to fine channel c (the s2d views of the JAX package).
//
// Layout: x, residual and out are contiguous (N, S, C) -- channels last,
// the NDHWC layout of the port's activations.
//
// Bound on the H100: memory, at a few flops per byte.  The function must
// read x once and write the output once (plus one read of the residual);
// the two-pass algorithm reads x a second time.  What the design does:
//   * One partition of the work for both phases.  Each sample's S rows are
//     cut into `bps` chunks of `rows_per_block` rows, one block per chunk;
//     thread (r0, g) of a block owns lane group g (16 bytes: 8 bf16 or 4
//     f32 lanes) of rows first + k * rpi, so its partial sums and, later,
//     its a and b stay in registers.  Loads are 16 bytes a thread,
//     neighbouring threads on neighbouring addresses, 8 (statistics) or 4
//     (apply) in flight; all offsets inside a sample are 32-bit.
//   * The block folds its per-thread sums with all threads in a fixed
//     order (fold()), publishes them, and takes a ticket: the block that
//     draws the last one for sample n folds the blocks' partials the same
//     way (8 loads in flight a thread), folds the s2d offsets, writes a and
//     b, and returns the ticket to zero for the next call.  No float
//     atomics: every f32 sum has a fixed order, so two calls give the same
//     bits.
//   * The apply walks each thread's rows in reverse, so it starts on the
//     rows the statistics read last, the ones most likely still in L2.
//   * Two routes (ops/fusednorm.py plan_launch picks one by the shape):
//       fused -- one cooperative launch, every sample on `bps` co-resident
//         blocks.  Each thread keeps its first `staged` packs in shared
//         memory; the blocks of a sample meet at a barrier after the
//         statistics (the last block publishes a and b and bumps the
//         sample's generation word), then apply, re-reading the staged
//         packs from shared memory and the rest from L2.  Taken where all
//         samples fit on the chip at once.
//       split -- a statistics launch and an apply launch over the same
//         partition, for larger tensors.
//   * The workspace (partials, a and b, tickets, generation words) is the
//     caller's, kept across calls: nothing is allocated or zeroed per call.
//   * No argument changes from call to call but the pointers, so a CUDA
//     graph may capture the launch and replay it.  The fused route's
//     barrier needs a value that is new each call; the card derives it:
//     every block reads its sample's generation word before it takes its
//     ticket, and the block that draws the last ticket, which every other
//     block's read precedes, publishes a and b and then bumps the word.
//     So all blocks of a call read the same generation g, and wait for
//     g + 1.
//   * The absmax variant (AMAX) also reports, per sample, the max of |out|
//     over every element it writes (after the cast and the residual add):
//     the input statistic of the int8 activation quantizer (quantize.cu),
//     which then reads x once instead of twice.  Each thread keeps the max
//     of the bit patterns of |out| with the sign cleared (ordered like the
//     floats for non-negative values, a NaN above inf, as quantize.cu
//     orders them); warp and block reductions, then one atomicMax per block
//     on the sample's slot.  The sample's last statistics block zeroes the
//     slot before any apply block of the call runs: before it bumps the
//     sample's generation on the fused route, in the statistics launch on
//     the split route.  No memset.
//   * The external-statistics variant (dctseg_fusednorm_ext) serves a
//     volume whose D axis is sharded over several GPUs: the split route's
//     two launches, called apart.  The statistics launch's last block
//     writes the sample's raw f32 sums of x and x^2 per fine channel
//     ([n][2][f], the offsets folded) instead of a and b; the caller
//     all-reduces them over the GPUs; the apply launch takes the reduced
//     sums and the whole volume's count and computes a and b per lane by
//     the same formula.  With the local count it gives the split route's
//     bits.  With absmax slots (the int8 forward on a slab) it reports
//     them as the absmax variant does: the statistics launch zeroes them,
//     the apply launch fills them; the caller reduces them over the GPUs
//     with its own collective (ops/quant.py quantize_input).

#include <stdint.h>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;
constexpr int kStatsUnroll = 8;   // loads in flight a thread, statistics
constexpr int kApplyUnroll = 4;   // rows in flight a thread, apply
constexpr int kBatch = 8;         // loads in flight a thread, fold()
// About a second of polling before a barrier that never opens traps
// instead of hanging the card.
constexpr unsigned kMaxSpins = 1u << 24;

enum Mode : int { kStats = 0, kApply = 1, kFused = 2 };
enum Act : int { kNone = 0, kRelu = 1, kLrelu = 2 };
// or-ed into the act argument: the residual goes in before the activation
constexpr int kResidualBefore = 8;
// RES: no residual, added after the activation and the cast, or before
enum Res : int { kNoRes = 0, kResAfter = 1, kResBefore = 2 };

struct Params {
  const void* x;
  const void* res;            // null without a residual
  void* out;
  float* ab;                  // [n][2][c]: scales, then shifts
  float* partial;             // [n][bps][2][c]: sums, then squares
  unsigned* tickets;          // [n], zero between calls
  unsigned* generations;      // [n], fused calls finished per sample
  unsigned* amax;             // [n] bits of max |out| (AMAX), else null
  // external statistics: [n][2][f] sums of x, then of x^2 (the statistics
  // launch writes them, the apply launch reads them); null otherwise
  float* sums;
  int n, s, c, f, bps, rows_per_block, act;
  int staged;                 // fused route: packs a thread keeps in smem
  float eps, slope;
  float count;                // external statistics: the elements summed
};

__device__ __forceinline__ float activate(float y, int act, float slope) {
  if (act == kRelu) return y > 0.f ? y : 0.f;
  if (act == kLrelu) return y >= 0.f ? y : slope * y;
  return y;
}

// The scale a and shift b of a fine channel from its sums of x and x^2
// over cnt elements.  Rounded operations throughout, so that no product is
// fused into an FMA: the statistics' last block and the
// external-statistics apply, which computes them in registers, give the
// same bits (and the plain version's order of operations).
__device__ __forceinline__ float2 scale_shift(float s, float q, float cnt,
                                              float eps) {
  const float mean = __fdiv_rn(s, cnt);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(q, cnt), __fmul_rn(mean, mean)), 0.f);
  const float scale = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  return make_float2(scale, __fmul_rn(-mean, scale));
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// Lane l of rows first, first + step, ... < rows of two arrays (load(r, l)
// gives the pair), summed in that order with kBatch loads in flight.
template <typename Load>
__device__ __forceinline__ float2 fold_lane(int rows, int first, int step,
                                            int l, Load load) {
  float a = 0.f, b = 0.f;
  for (int r = first; r < rows; r += kBatch * step) {
    float2 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (r + u * step < rows) v[u] = load(r + u * step, l);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r + u * step < rows) {
        a += v[u].x;
        b += v[u].y;
      }
    }
  }
  return make_float2(a, b);
}

// Sums `rows` rows of c lanes of two arrays in a fixed order with all
// threads: thread (l, j) adds rows j, j + J, ... of lane l, then lane l's
// thread adds the J partial sums in order.  Leaves the sums in tot[0, c)
// and tot[c, 2c); ends with __syncthreads().
template <typename Load>
__device__ __forceinline__ void fold(int rows, int c, Load load, float* part,
                                     float* tot) {
  const int tid = threadIdx.x;
  if (c <= kThreads) {
    const int J = kThreads / c;
    const int l = tid % c, j = tid / c;
    if (j < J) {
      const float2 v = fold_lane(rows, j, J, l, load);
      part[j * c + l] = v.x;
      part[kThreads + j * c + l] = v.y;
    }
    __syncthreads();
    if (tid < c) {
      float a = 0.f, b = 0.f;
      for (int k = 0; k < J; ++k) {
        a += part[k * c + tid];
        b += part[kThreads + k * c + tid];
      }
      tot[tid] = a;
      tot[c + tid] = b;
    }
  } else {
    for (int l = tid; l < c; l += kThreads) {
      const float2 v = fold_lane(rows, 0, 1, l, load);
      tot[l] = v.x;
      tot[c + l] = v.y;
    }
  }
  __syncthreads();
}

template <typename T, int VEC, int MODE, int RES, bool AMAX>
__global__ void __launch_bounds__(kThreads) norm_kernel(const Params p) {
  using P = Pack<T, VEC>;
  __shared__ float rowsum[2 * kThreads * VEC];   // [rpi][c] sums, squares
  __shared__ float part[2 * kThreads];
  __shared__ float tot[2 * kThreads * VEC];
  __shared__ int is_last;
  __shared__ unsigned generation;   // fused route: the sample's, this call
  // fused route: the first p.staged packs of each thread, [k][kThreads]
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  P* stage = reinterpret_cast<P*>(dynamic_smem);

  const int c = p.c;
  const int groups = c / VEC;
  const int rpi = kThreads / groups;   // rows per iteration of the block
  const int tid = threadIdx.x;
  const bool active = tid < rpi * groups;
  const int g = tid % groups;
  const int r0 = tid / groups;
  const int row_begin = blockIdx.x * p.rows_per_block;
  const int row_end = min(p.s, row_begin + p.rows_per_block);
  const int first = row_begin + r0;
  // this thread's rows: first + k * rpi, k < nk
  const int nk = active && first < row_end ? (row_end - first + rpi - 1) / rpi
                                           : 0;
  // fused route: rows k < staged stay in shared memory, the rest are
  // re-read
  const int staged = MODE == kFused ? min(nk, p.staged) : 0;

  const int n = blockIdx.y;
  const size_t base = (size_t)n * p.s * c + g * VEC;
  const T* xs = static_cast<const T*>(p.x) + base;
  if (MODE != kApply) {
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
    auto add = [&](const P& v) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(v.v[j]);
        s[j] += f;
        q[j] += f * f;
      }
    };
    int k = 0;
    for (; k + kStatsUnroll <= nk; k += kStatsUnroll) {
      P v[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        v[u] = load_pack<T, VEC>(xs + (first + (k + u) * rpi) * c);
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        if (k + u < staged) stage[(k + u) * kThreads + tid] = v[u];
        add(v[u]);
      }
    }
    for (; k < nk; ++k) {
      const P v = load_pack<T, VEC>(xs + (first + k * rpi) * c);
      if (k < staged) stage[k * kThreads + tid] = v;
      add(v);
    }
    // thread tid = r0 * groups + g holds lanes g*VEC.. of row r0
    if (active) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        rowsum[tid * VEC + j] = s[j];
        rowsum[kThreads * VEC + tid * VEC + j] = q[j];
      }
    }
    __syncthreads();
    fold(rpi, c,
         [&](int r, int l) {
           return make_float2(rowsum[r * c + l],
                              rowsum[kThreads * VEC + r * c + l]);
         },
         part, tot);
    float* pb = p.partial + ((size_t)n * p.bps + blockIdx.x) * 2 * c;
    for (int l = tid; l < 2 * c; l += kThreads) pb[l] = tot[l];
    // Publish the partials, then take a ticket: the block that draws the
    // last one for sample n finishes its statistics.
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      // the generation is read before the ticket is taken: the last
      // ticket's block bumps it only after every block's read
      if (MODE == kFused) {
        generation =
            *reinterpret_cast<volatile unsigned*>(p.generations + n);
        __threadfence();
      }
      is_last = atomicAdd(p.tickets + n, 1u) == (unsigned)(p.bps - 1);
    }
    __syncthreads();
    if (is_last) {
      __threadfence();
      const float* pn = p.partial + (size_t)n * p.bps * 2 * c;
      fold(p.bps, c,
           [&](int r, int l) {
             return make_float2(__ldcg(pn + (size_t)r * 2 * c + l),
                                __ldcg(pn + (size_t)r * 2 * c + c + l));
           },
           part, tot);
      const int offsets = c / p.f;
      const float cnt = (float)((long long)p.s * offsets);
      float* abn = p.ab + (size_t)n * 2 * c;
      for (int ch = tid; ch < p.f; ch += kThreads) {
        float a = 0.f, b = 0.f;
        for (int o = 0; o < offsets; ++o) {
          a += tot[o * p.f + ch];
          b += tot[c + o * p.f + ch];
        }
        if (p.sums) {   // external statistics: the raw sums
          p.sums[(size_t)n * 2 * p.f + ch] = a;
          p.sums[(size_t)n * 2 * p.f + p.f + ch] = b;
          continue;
        }
        const float2 ab = scale_shift(a, b, cnt, p.eps);
        for (int o = 0; o < offsets; ++o) {
          abn[o * p.f + ch] = ab.x;
          abn[c + o * p.f + ch] = ab.y;
        }
      }
      // the absmax slot starts this call at zero, before any apply block
      if (tid == 0 && p.amax) p.amax[n] = 0u;
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        p.tickets[n] = 0;
        if (MODE == kFused) atomicExch(p.generations + n, generation + 1u);
      }
    }
  }
  if (MODE == kStats) return;
  if (MODE == kFused) {
    if (tid == 0) {
      unsigned spins = 0;
      while (*reinterpret_cast<volatile unsigned*>(p.generations + n) ==
             generation) {
        __nanosleep(64);
        if (++spins > kMaxSpins) __trap();
      }
      __threadfence();
    }
    __syncthreads();
  }
  // the absmax variant's block reduction needs every thread
  if (!AMAX && nk == 0) return;
  float sa[VEC], sb[VEC];
  if (MODE == kApply && p.sums) {
    // external statistics: a and b of each lane's fine channel from the
    // reduced sums, as the statistics' last block computes them
    const float* sn = p.sums + (size_t)n * 2 * p.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ch = (g * VEC + j) % p.f;
      const float2 ab =
          scale_shift(__ldcg(sn + ch), __ldcg(sn + p.f + ch), p.count, p.eps);
      sa[j] = ab.x;
      sb[j] = ab.y;
    }
  } else {
    const float* abn = p.ab + (size_t)n * 2 * c + g * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sa[j] = __ldcg(abn + j);
      sb[j] = __ldcg(abn + c + j);
    }
  }
  const T* rs = RES ? static_cast<const T*>(p.res) + base : nullptr;
  T* os = static_cast<T*>(p.out) + base;
  // rows from the last read to the first: the re-read ones (from L2
  // where they are still there), then the staged ones from shared memory
  auto fetch = [&](int k) {
    return k < staged ? stage[k * kThreads + tid]
                      : load_pack<T, VEC>(xs + (first + k * rpi) * c);
  };
  unsigned m = 0;   // AMAX: the max bits of |out| this thread wrote
  auto apply = [&](const P& v, const P& r) {
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = to_f32(v.v[j]) * sa[j] + sb[j];
      if (RES == kResBefore) {
        o.v[j] = from_f32<T>(activate(y + to_f32(r.v[j]), p.act, p.slope));
      } else {
        const T yc = from_f32<T>(activate(y, p.act, p.slope));
        o.v[j] = RES ? from_f32<T>(to_f32(yc) + to_f32(r.v[j])) : yc;
      }
      if (AMAX) m = max(m, __float_as_uint(to_f32(o.v[j])) & 0x7fffffffu);
    }
    return o;
  };
  int k = nk - 1;
  for (; k >= kApplyUnroll - 1; k -= kApplyUnroll) {
    P v[kApplyUnroll], r[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      v[u] = fetch(k - u);
      if (RES) r[u] = load_pack<T, VEC>(rs + (first + (k - u) * rpi) * c);
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u)
      *reinterpret_cast<P*>(os + (first + (k - u) * rpi) * c) =
          apply(v[u], r[u]);
  }
  for (; k >= 0; --k) {
    const int off = (first + k * rpi) * c;
    P r;
    if (RES) r = load_pack<T, VEC>(rs + off);
    *reinterpret_cast<P*>(os + off) = apply(fetch(k), r);
  }
  if (AMAX) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    // part is free again: the statistics' fold() ended with a barrier
    unsigned* warp_max = reinterpret_cast<unsigned*>(part);
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    if (tid < 32) {
      m = tid < kThreads / 32 ? warp_max[tid] : 0u;
#pragma unroll
      for (int off = 4; off; off >>= 1)
        m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (tid == 0) atomicMax(p.amax + n, m);
    }
  }
}

template <typename T, int VEC, int MODE, int RES>
const void* kernel_with(bool amax) {
  if (amax)
    return reinterpret_cast<const void*>(&norm_kernel<T, VEC, MODE, RES, true>);
  return reinterpret_cast<const void*>(&norm_kernel<T, VEC, MODE, RES, false>);
}

template <typename T, int VEC, int MODE>
const void* kernel_of(int res, bool amax) {
  if constexpr (MODE == kStats) {
    return reinterpret_cast<const void*>(&norm_kernel<T, VEC, kStats, kNoRes,
                                                      false>);
  } else {
    if (res == kResBefore)   // no absmax variant on this route
      return amax ? nullptr
                  : reinterpret_cast<const void*>(
                        &norm_kernel<T, VEC, MODE, kResBefore, false>);
    return res ? kernel_with<T, VEC, MODE, kResAfter>(amax)
               : kernel_with<T, VEC, MODE, kNoRes>(amax);
  }
}

// The kernel for (dtype, vec, mode, residual route (Res), absmax); the
// stats pass ignores the residual and the absmax (it only zeroes the
// slots).
template <int MODE>
const void* pick(int dtype, int vec, int res, bool amax) {
  res = MODE != kStats ? res : kNoRes;
  amax = amax && MODE != kStats;
  if (dtype == kF32 && vec == 4) return kernel_of<float, 4, MODE>(res, amax);
  if (dtype == kF32 && vec == 1) return kernel_of<float, 1, MODE>(res, amax);
  if (dtype == kBF16 && vec == 8)
    return kernel_of<__nv_bfloat16, 8, MODE>(res, amax);
  if (dtype == kBF16 && vec == 1)
    return kernel_of<__nv_bfloat16, 1, MODE>(res, amax);
  if (dtype == kF16 && vec == 8) return kernel_of<__half, 8, MODE>(res, amax);
  if (dtype == kF16 && vec == 1) return kernel_of<__half, 1, MODE>(res, amax);
  return nullptr;
}

cudaError_t blocks_per_sm(const void* k, size_t smem, int* out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kThreads, smem);
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// What the card holds at once, for (dtype, vec, residual route: Res) and
// the variant
// (amax: with the absmax output), on the current device; each variant has
// its own plan.  Split route (fused == 0): the blocks of the less-occupying
// of its two kernels, one wave.  Fused route: the blocks of its kernel (the
// largest grid its cooperative launch takes) and the shared memory each
// block may stage rows in without lowering that count; also raises the
// kernel's dynamic shared-memory limit to match.
extern "C" int dctseg_fusednorm_coresident(int dtype, int vec, int fused,
                                           int res, int amax, int* blocks,
                                           int* stage_bytes) {
  const void* k = fused ? pick<kFused>(dtype, vec, res, amax)
                        : pick<kStats>(dtype, vec, res, false);
  const void* apply = fused ? k : pick<kApply>(dtype, vec, res, amax);
  if (!k) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, sm_smem = 0, per_sm = 0, per_sm2 = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (!err) err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = cudaDeviceGetAttribute(
      &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (!err) err = blocks_per_sm(k, 0, &per_sm);
  if (!err) err = blocks_per_sm(apply, 0, &per_sm2);
  if (!err) err = cudaFuncGetAttributes(&attr, k);
  if (err) return err;
  per_sm = min(per_sm, per_sm2);
  *blocks = per_sm * sms;
  *stage_bytes = 0;
  if (!fused || per_sm < 1) return cudaSuccess;
  const int room = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             room);
  // the block's share of the SM, less its static part (and the 1 KB the
  // SM reserves per block), in whole 4 KB steps, as long as the count holds
  int bytes = max(0, min(room, sm_smem / per_sm - 1024 -
                                   (int)attr.sharedSizeBytes)) & ~4095;
  int with = 0;
  while (!err && bytes > 0 && !(err = blocks_per_sm(k, bytes, &with)) &&
         with < per_sm)
    bytes -= 4096;
  *stage_bytes = bytes;
  return err;
}

// args (int64, ops/fusednorm.py launch_args): x, residual (0 for none),
// out, ab, partial, tickets, generations, n, s, c, f, bps, rows_per_block,
// act (| kResidualBefore: the pre-activation residual route), dtype, vec,
// fused, staged, amax (0 for none: the plain variant).  The
// wrapper guarantees c / vec <= 256, f | c, s * c < 2^31, 16-byte pointers
// where vec > 1, and for the fused route a grid of bps * n co-resident
// blocks.
extern "C" int dctseg_fusednorm(const int64_t* a, float eps, float slope,
                                void* stream) {
  Params p;
  p.x = reinterpret_cast<const void*>(a[0]);
  p.res = reinterpret_cast<const void*>(a[1]);
  p.out = reinterpret_cast<void*>(a[2]);
  p.ab = reinterpret_cast<float*>(a[3]);
  p.partial = reinterpret_cast<float*>(a[4]);
  p.tickets = reinterpret_cast<unsigned*>(a[5]);
  p.generations = reinterpret_cast<unsigned*>(a[6]);
  p.n = (int)a[7];
  p.s = (int)a[8];
  p.c = (int)a[9];
  p.f = (int)a[10];
  p.bps = (int)a[11];
  p.rows_per_block = (int)a[12];
  p.act = (int)a[13];
  const int dtype = (int)a[14], vec = (int)a[15];
  const bool fused = a[16] != 0;
  p.staged = (int)a[17];
  p.amax = reinterpret_cast<unsigned*>(a[18]);
  p.sums = nullptr;
  p.eps = eps;
  p.slope = slope;
  p.count = 0.f;
  const bool amax = p.amax != nullptr;
  const int res = p.res == nullptr ? kNoRes
                  : (p.act & kResidualBefore) ? kResBefore : kResAfter;
  p.act &= ~kResidualBefore;
  if (p.c % vec || p.c / vec > kThreads || p.f < 1 || p.c % p.f ||
      p.bps < 1 || p.n < 1 || p.n > 65535 || p.staged < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  void* args[] = {&p};
  // Both routes take no host state that changes per call (the pointers
  // aside): a captured launch replays as it ran.
  if (fused) {
    const void* k = pick<kFused>(dtype, vec, res, amax);
    if (!k) return cudaErrorInvalidValue;
    const size_t pack = (size_t)vec * (dtype == kF32 ? 4 : 2);
    return cudaLaunchCooperativeKernel(k, dim3(p.bps, p.n), block, args,
                                       (size_t)p.staged * kThreads * pack, st);
  }
  const void* stats = pick<kStats>(dtype, vec, false, false);
  const void* apply = pick<kApply>(dtype, vec, res, amax);
  if (!stats || p.staged) return cudaErrorInvalidValue;
  cudaError_t err = cudaLaunchKernel(stats, dim3(p.bps, p.n), block, args, 0,
                                     st);
  if (err) return err;
  return cudaLaunchKernel(apply, dim3(p.bps, p.n), block, args, 0, st);
}

// The external-statistics variant: one launch of the split route, phase 0
// its statistics launch, writing the raw sums (sums: [n][2][f] f32), phase
// 1 its apply launch, reading the sums reduced over the GPUs and `count`,
// the elements they summed per sample and fine channel.  args: those of
// dctseg_fusednorm (fused 0, staged 0; amax: the [n] absmax slots, or 0),
// then the sums' address.  With slots, both phases take them: phase 0
// zeroes them, phase 1 fills them with max |out| per sample; the plan
// (bps, rows_per_block) is the absmax variant's split plan.
extern "C" int dctseg_fusednorm_ext(const int64_t* a, float eps, float slope,
                                    float count, int phase, void* stream) {
  Params p;
  p.x = reinterpret_cast<const void*>(a[0]);
  p.res = reinterpret_cast<const void*>(a[1]);
  p.out = reinterpret_cast<void*>(a[2]);
  p.ab = reinterpret_cast<float*>(a[3]);
  p.partial = reinterpret_cast<float*>(a[4]);
  p.tickets = reinterpret_cast<unsigned*>(a[5]);
  p.generations = reinterpret_cast<unsigned*>(a[6]);
  p.n = (int)a[7];
  p.s = (int)a[8];
  p.c = (int)a[9];
  p.f = (int)a[10];
  p.bps = (int)a[11];
  p.rows_per_block = (int)a[12];
  p.act = (int)a[13];
  const int dtype = (int)a[14], vec = (int)a[15];
  p.staged = (int)a[17];
  p.amax = reinterpret_cast<unsigned*>(a[18]);
  p.sums = reinterpret_cast<float*>(a[19]);
  p.eps = eps;
  p.slope = slope;
  p.count = count;
  if (a[16] || a[18] % 4 || !p.sums || p.staged || !(count > 0.f) ||
      p.c % vec || p.c / vec > kThreads || p.f < 1 || p.c % p.f ||
      p.bps < 1 || p.n < 1 || p.n > 65535 || (phase != 0 && phase != 1))
    return cudaErrorInvalidValue;
  const void* k = phase == 0 ? pick<kStats>(dtype, vec, false, false)
                             : pick<kApply>(dtype, vec, p.res != nullptr,
                                            p.amax != nullptr);
  if (!k) return cudaErrorInvalidValue;
  void* args[] = {&p};
  return cudaLaunchKernel(k, dim3(p.bps, p.n), dim3(kThreads), args, 0,
                          static_cast<cudaStream_t>(stream));
}

// The message of an error code returned by any entry of the library
// (ops/_build.py check()).
extern "C" const char* dctseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
