// Dynamic per-tensor symmetric int8 quantization of an activation, for
// Hopper (sm_90a): K7 of the port, the input side of K6 (int8conv.cu).
//
// The JAX package computes it in XLA inside dctseg/ops/quant.py
// conv3d_int8 (:131-133); there is no Pallas kernel.  The function:
//   amax = max |x|                      (a NaN propagates, as jnp.max)
//   sx   = max(amax, 1e-12) / 127
//   xq   = int8(clip(round_half_even(x / sx), -127, 127))
// in f32 arithmetic whatever x's dtype, with a true division (no
// reciprocal) and rintf's round-half-even, as jnp.round and torch.round.
// stats[0] receives amax and stats[1] sx, both on the card, so that K6
// reads the scale without a host sync.
//
// Bound on the H100: bytes.  The function must read x once and write xq
// once; the absmax must be known before the first byte is quantized, so a
// kernel that finds it itself reads x twice.  Each thread moves VEC
// elements (16 bytes of x where the widths allow) per step, kUnroll steps
// in flight.  A true division per element would make the quantize pass
// bound by instructions instead (quantize_one says how it avoids one).
// Max |x| is kept as the max of the bit patterns of |x| with the sign
// cleared, which orders like the floats for non-negative values and puts
// a NaN above inf.  One launch a call on every route, and no memset:
//   from_amax -- x was written by the fused norm (fusednorm.cu), which
//     already reduced max |x| per sample into `amax`: each block folds
//     those few slots, computes sx, and the grid quantizes x in one
//     grid-stride read (block 0 writes stats).  One read of x.
//   grid -- any other x: one cooperative launch of co-resident blocks.
//     Each block reduces its grid-stride share of x, then one atomicMax on
//     a word of the caller's workspace and a ticket; the block that draws
//     the last ticket reads the word back and zeroes it (and the ticket)
//     for the next call, writes stats, and bumps a generation word, which
//     the other blocks wait for.  Then every block quantizes its share,
//     walking it backwards, so that it starts on what the absmax read
//     last, the part most likely still in L2.
//   amax -- the absmax alone, into a one-float slot: over a mesh of GPUs
//     the slots of every rank's part of the tensor are MAX-reduced between
//     the absmax and the quantize (ops/quant.py quantize_input), and a
//     cooperative launch cannot hold that collective.  Any grid: each block
//     reduces its grid-stride share, then one atomicMax on the workspace's
//     word and a ticket, as on the grid route; the last ticket's block
//     writes the slot and leaves the word and the ticket at zero.  Nobody
//     waits, so the blocks need not be co-resident.  One read of x.
// No argument changes from call to call but the pointers, so a CUDA graph
// may capture a launch and replay it: the grid route's barrier takes its
// new value from the card (the amax route shares its workspace and leaves
// the generation as it found it).  Every block reads the generation word before
// it takes its ticket, and the last ticket's block bumps it after every
// other block's read, so all blocks of a call read the same g and wait
// for g + 1.

#include <cstdint>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // vectors in flight a thread
// About a second of polling before a barrier that never opens traps
// instead of hanging the card.
constexpr unsigned kMaxSpins = 1u << 24;

// The caller's workspace of the grid route, zero between calls except
// `generation`, which counts the calls that have finished their absmax.
struct Workspace {
  unsigned* amax;        // bits of max |x| of the running call
  unsigned* ticket;      // blocks that have added theirs
  unsigned* generation;  // grid calls whose absmax is final
};

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// sx of an absmax; fmaxf would drop a NaN that jnp.maximum keeps
__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(isnan(amax) ? amax : fmaxf(amax, 1e-12f), 127.0f);
}

// 1.5 * 2^23: adding it to a float of [-127, 127] rounds it to the nearest
// integer, ties to even, into the low bits of the sum's significand
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;
// |v * rcp - v / sx| <= 127 * 2^-23 and |fl(v / sx) - v / sx| <= 127 *
// 2^-24 for |v| <= amax: below 2.3e-5 together, under half of this band
constexpr float kTieBand = 1.0f / 16384.0f;

// int8(clip(round_half_even(fl(v / sx)), -127, 127)), fl the correctly
// rounded division, from the product v * rcp (rcp = 1 / sx correctly
// rounded): the two lie within 2.3e-5 of each other, so they round to the
// same integer unless the product lies within kTieBand of a half-integer,
// and only there is the quotient computed.  Clipping before rounding
// gives the same integer as after; a NaN clips to -127 either way.
__device__ __forceinline__ int8_t quantize_one(float v, float sx,
                                               float rcp) {
  float c = fminf(fmaxf(__fmul_rn(v, rcp), -127.0f), 127.0f);
  float t = __fadd_rn(c, kMagic);
  if (fabsf(fabsf(__fsub_rn(c, __fsub_rn(t, kMagic))) - 0.5f) < kTieBand) {
    c = fminf(fmaxf(__fdiv_rn(v, sx), -127.0f), 127.0f);
    t = __fadd_rn(c, kMagic);
  }
  return static_cast<int8_t>(__float_as_int(t) - kMagicBits);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<int8_t, VEC> quantize_pack(
    const Pack<T, VEC>& p, float sx, float rcp) {
  Pack<int8_t, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o.v[j] = quantize_one(to_f32(p.v[j]), sx, rcp);
  return o;
}

// The block's max of m, valid in thread 0.
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
#pragma unroll
    for (int off = 4; off; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// The max bits of |x| over this thread's grid-stride vectors of x.
template <typename T, int VEC>
__device__ __forceinline__ unsigned share_max(const T* __restrict__ x,
                                              long long vectors) {
  using P = Pack<T, VEC>;
  const P* xv = reinterpret_cast<const P*>(x);
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned m = 0;
  for (; v + (kUnroll - 1) * stride < vectors; v += kUnroll * stride) {
    P p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u] = xv[v + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        m = max(m, abs_bits(to_f32(p[u].v[j])));
  }
  for (; v < vectors; v += stride) {
    const P p = xv[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m = max(m, abs_bits(to_f32(p.v[j])));
  }
  return m;
}

// Quantizes this thread's grid-stride vectors of x with scale sx, from
// the first (forward) or from the last.
template <typename T, int VEC>
__device__ __forceinline__ void quantize_share(const T* __restrict__ x,
                                               long long vectors, float sx,
                                               int8_t* __restrict__ q,
                                               bool backward) {
  using P = Pack<T, VEC>;
  using Q = Pack<int8_t, VEC>;
  const P* xv = reinterpret_cast<const P*>(x);
  Q* qv = reinterpret_cast<Q*>(q);
  const float rcp = __frcp_rn(sx);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long v0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long count = v0 < vectors ? (vectors - v0 + stride - 1) / stride
                                       : 0;
  long long k = 0;
  for (; k + kUnroll <= count; k += kUnroll) {
    P p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long kk = backward ? count - 1 - (k + u) : k + u;
      p[u] = xv[v0 + kk * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long kk = backward ? count - 1 - (k + u) : k + u;
      qv[v0 + kk * stride] = quantize_pack<T, VEC>(p[u], sx, rcp);
    }
  }
  for (; k < count; ++k) {
    const long long kk = backward ? count - 1 - k : k;
    qv[v0 + kk * stride] = quantize_pack<T, VEC>(xv[v0 + kk * stride], sx,
                                                 rcp);
  }
}

// Route from_amax: sx from the per-sample absmax slots the fused norm
// wrote, then one read of x.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
from_amax_kernel(const T* __restrict__ x, long long vectors,
                 const float* __restrict__ slots, int nslots,
                 float* __restrict__ stats, int8_t* __restrict__ q) {
  unsigned bits = 0;
  for (int i = 0; i < nslots; ++i) bits = max(bits, abs_bits(slots[i]));
  const float amax = __uint_as_float(bits);
  const float sx = scale_of(amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[0] = amax;
    stats[1] = sx;
  }
  quantize_share<T, VEC>(x, vectors, sx, q, false);
}

// Route grid: one cooperative launch of co-resident blocks.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
grid_kernel(const T* __restrict__ x, long long vectors, Workspace ws,
            float* __restrict__ stats, int8_t* __restrict__ q) {
  __shared__ float block_sx;
  const unsigned m = block_max(share_max<T, VEC>(x, vectors));
  if (threadIdx.x == 0) {
    // this call's generation, read before the ticket is taken
    const unsigned generation =
        *reinterpret_cast<volatile unsigned*>(ws.generation);
    __threadfence();
    atomicMax(ws.amax, m);
    __threadfence();
    if (atomicAdd(ws.ticket, 1u) == gridDim.x - 1) {
      // every block's max is in: read it back and leave the word and the
      // ticket at zero for the next call
      __threadfence();
      const float amax = __uint_as_float(atomicExch(ws.amax, 0u));
      stats[0] = amax;
      stats[1] = scale_of(amax);
      *ws.ticket = 0u;
      __threadfence();
      atomicExch(ws.generation, generation + 1u);
    } else {
      unsigned spins = 0;
      while (*reinterpret_cast<volatile unsigned*>(ws.generation) ==
             generation) {
        __nanosleep(64);
        if (++spins > kMaxSpins) __trap();
      }
      __threadfence();
    }
    block_sx = __ldcg(stats + 1);
  }
  __syncthreads();
  quantize_share<T, VEC>(x, vectors, block_sx, q, true);
}

// Route amax: max |x| into slot[0], any grid, no barrier.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, long long vectors, Workspace ws,
            float* __restrict__ slot) {
  const unsigned m = block_max(share_max<T, VEC>(x, vectors));
  if (threadIdx.x == 0) {
    atomicMax(ws.amax, m);
    __threadfence();
    if (atomicAdd(ws.ticket, 1u) == gridDim.x - 1) {
      // every block's max is in: hand it out, leave the words at zero
      __threadfence();
      *slot = __uint_as_float(atomicExch(ws.amax, 0u));
      *ws.ticket = 0u;
    }
  }
}

int itemsize(int dtype) { return dtype == kF32 ? 4 : 2; }

template <typename T, int VEC>
const void* grid_kernel_of() {
  return reinterpret_cast<const void*>(&grid_kernel<T, VEC>);
}

// grid_kernel for (dtype, vec), or null
const void* pick_grid(int dtype, int vec) {
  switch (dtype * 16 + vec) {
    case kF32 * 16 + 4: return grid_kernel_of<float, 4>();
    case kF32 * 16 + 2: return grid_kernel_of<float, 2>();
    case kF32 * 16 + 1: return grid_kernel_of<float, 1>();
    case kBF16 * 16 + 8: return grid_kernel_of<__nv_bfloat16, 8>();
    case kBF16 * 16 + 4: return grid_kernel_of<__nv_bfloat16, 4>();
    case kBF16 * 16 + 2: return grid_kernel_of<__nv_bfloat16, 2>();
    case kBF16 * 16 + 1: return grid_kernel_of<__nv_bfloat16, 1>();
    case kF16 * 16 + 8: return grid_kernel_of<__half, 8>();
    case kF16 * 16 + 4: return grid_kernel_of<__half, 4>();
    case kF16 * 16 + 2: return grid_kernel_of<__half, 2>();
    case kF16 * 16 + 1: return grid_kernel_of<__half, 1>();
    default: return nullptr;
  }
}

template <typename T>
int launch_from_amax(const void* x, long long vectors, int vec, int grid,
                     const float* slots, int nslots, float* stats, int8_t* q,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  switch (vec) {
#define DCTSEG_QUANT_CASE(V)                                                 \
    case V:                                                                  \
      if constexpr (V * sizeof(T) <= 16) {                                   \
        from_amax_kernel<T, V><<<grid, kThreads, 0, stream>>>(               \
            xt, vectors, slots, nslots, stats, q);                           \
        return cudaGetLastError();                                           \
      }                                                                      \
      return cudaErrorInvalidValue;
    DCTSEG_QUANT_CASE(8)
    DCTSEG_QUANT_CASE(4)
    DCTSEG_QUANT_CASE(2)
    DCTSEG_QUANT_CASE(1)
#undef DCTSEG_QUANT_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_amax(const void* x, long long vectors, int vec, int grid,
                Workspace ws, float* slot, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  switch (vec) {
#define DCTSEG_AMAX_CASE(V)                                                  \
    case V:                                                                  \
      if constexpr (V * sizeof(T) <= 16) {                                   \
        amax_kernel<T, V><<<grid, kThreads, 0, stream>>>(xt, vectors, ws,    \
                                                         slot);              \
        return cudaGetLastError();                                           \
      }                                                                      \
      return cudaErrorInvalidValue;
    DCTSEG_AMAX_CASE(8)
    DCTSEG_AMAX_CASE(4)
    DCTSEG_AMAX_CASE(2)
    DCTSEG_AMAX_CASE(1)
#undef DCTSEG_AMAX_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// The blocks of the grid route's kernel for (dtype, vec) that the current
// device holds at once: the largest grid its cooperative launch takes.
extern "C" int dctseg_quantize_coresident(int dtype, int vec, int* blocks) {
  const void* k = pick_grid(dtype, vec);
  if (!k) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k, kThreads, 0);
  *blocks = per_sm * sms;
  return err;
}

// args (int64, ops/quant.py quantize_args): x, q, stats, n, dtype, vec,
// grid, route, amax slots, slot count, workspace.  x: contiguous, n
// elements of dtype; q: n int8; stats: float32 [2].  Route 0 (from_amax):
// the float32 slots, whose max is max |x|.  Route 1 (grid: a grid of
// co-resident blocks): the workspace, three uint32 words, zero but for the
// last (the generation).  Route 2 (amax): no q; stats is the one-float
// slot; the grid route's workspace.  A vector width that does not divide n or fit the
// pointers is refused.  Neither route takes host state that changes per
// call (the pointers aside): a captured launch replays as it ran.
extern "C" int dctseg_quantize(const int64_t* a, void* stream) {
  const long long n = a[3];
  const int dtype = (int)a[4], vec = (int)a[5], grid = (int)a[6];
  const int route = (int)a[7];
  if (n < 1 || grid < 1 || vec < 1 || n % vec || a[0] % (vec * itemsize(dtype))
      || a[1] % vec || a[2] % 4 || vec * itemsize(dtype) > 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* x = reinterpret_cast<const void*>(a[0]);
  int8_t* q = reinterpret_cast<int8_t*>(a[1]);
  float* stats = reinterpret_cast<float*>(a[2]);
  long long vectors = n / vec;
  if (route == 0) {
    const float* slots = reinterpret_cast<const float*>(a[8]);
    const int nslots = (int)a[9];
    if (nslots < 1 || a[8] % 4) return cudaErrorInvalidValue;
    switch (dtype) {
      case kF32: return launch_from_amax<float>(x, vectors, vec, grid, slots,
                                                nslots, stats, q, s);
      case kBF16: return launch_from_amax<__nv_bfloat16>(
          x, vectors, vec, grid, slots, nslots, stats, q, s);
      case kF16: return launch_from_amax<__half>(x, vectors, vec, grid, slots,
                                                 nslots, stats, q, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if ((route != 1 && route != 2) || !a[10] || a[10] % 4)
    return cudaErrorInvalidValue;
  unsigned* words = reinterpret_cast<unsigned*>(a[10]);
  Workspace ws{words, words + 1, words + 2};
  if (route == 2) {
    switch (dtype) {
      case kF32: return launch_amax<float>(x, vectors, vec, grid, ws, stats,
                                           s);
      case kBF16: return launch_amax<__nv_bfloat16>(x, vectors, vec, grid,
                                                    ws, stats, s);
      case kF16: return launch_amax<__half>(x, vectors, vec, grid, ws, stats,
                                            s);
      default: return cudaErrorInvalidValue;
    }
  }
  const void* k = pick_grid(dtype, vec);
  if (!k) return cudaErrorInvalidValue;
  void* args[] = {&x, &vectors, &ws, &stats, &q};
  return cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args, 0,
                                     s);
}
