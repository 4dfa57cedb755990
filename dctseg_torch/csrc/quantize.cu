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
// Two launches on the caller's stream, after a 4-byte memset of stats[0]:
//   1. absmax: a grid-stride pass; each thread keeps the max of the bit
//      patterns of |x| (sign cleared), which orders like the floats for
//      non-negative values and puts a NaN above inf; warp and block
//      reductions, then one atomicMax per block on stats[0];
//   2. quantize: a grid-stride pass that reads stats[0], computes sx and
//      writes int8 (block 0 also writes sx to stats[1]).
// Bound on the H100: bytes (x read twice, xq written once); each thread
// moves VEC elements (16 bytes of x where the widths allow) per step.

#include <cstdint>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, long long vectors,
              unsigned int* __restrict__ amax_bits) {
  unsigned int m = 0;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < vectors; v += (long long)gridDim.x * kThreads) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(x)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      m = max(m, __float_as_uint(to_f32(p.v[j])) & 0x7fffffffu);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned int warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
#pragma unroll
    for (int off = 4; off; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) atomicMax(amax_bits, m);
  }
}

__device__ __forceinline__ int8_t quantize_one(float v, float sx) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long vectors,
                float* __restrict__ stats, int8_t* __restrict__ q) {
  const float amax = stats[0];
  // fmaxf would drop a NaN that jnp.maximum keeps
  const float sx = __fdiv_rn(isnan(amax) ? amax : fmaxf(amax, 1e-12f),
                             127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) stats[1] = sx;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < vectors; v += (long long)gridDim.x * kThreads) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(x)[v];
    Pack<int8_t, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = quantize_one(to_f32(p.v[j]), sx);
    reinterpret_cast<Pack<int8_t, VEC>*>(q)[v] = o;
  }
}

template <typename T>
int launch(const void* x, long long n, int vec, int grid, float* stats,
           int8_t* q, cudaStream_t stream) {
  const long long vectors = n / vec;
  unsigned int* bits = reinterpret_cast<unsigned int*>(stats);
  const T* xt = static_cast<const T*>(x);
  switch (vec) {
#define DCTSEG_QUANT_CASE(V)                                                 \
    case V:                                                                  \
      if constexpr (V * sizeof(T) <= 16) {                                   \
        absmax_kernel<T, V><<<grid, kThreads, 0, stream>>>(xt, vectors,      \
                                                           bits);            \
        if (cudaError_t e = cudaGetLastError()) return e;                    \
        quantize_kernel<T, V><<<grid, kThreads, 0, stream>>>(xt, vectors,    \
                                                             stats, q);      \
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

int itemsize(int dtype) { return dtype == kF32 ? 4 : 2; }

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// args (int64, ops/quant.py _quantize_launch): x, q, stats, n, dtype, vec,
// grid.  x: contiguous, n elements of dtype; q: n int8; stats: float32 [2].
// A vector width that does not divide n or fit the pointers is refused.
extern "C" int dctseg_quantize_absmax(const int64_t* a, void* stream) {
  const long long n = a[3];
  const int dtype = (int)a[4], vec = (int)a[5], grid = (int)a[6];
  if (n < 1 || grid < 1 || vec < 1 || n % vec || a[0] % (vec * itemsize(dtype))
      || a[1] % vec || a[2] % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = reinterpret_cast<float*>(a[2]);
  if (cudaError_t e = cudaMemsetAsync(stats, 0, sizeof(float), s)) return e;
  const void* x = reinterpret_cast<const void*>(a[0]);
  int8_t* q = reinterpret_cast<int8_t*>(a[1]);
  switch (dtype) {
    case kF32: return launch<float>(x, n, vec, grid, stats, q, s);
    case kBF16: return launch<__nv_bfloat16>(x, n, vec, grid, stats, q, s);
    case kF16: return launch<__half>(x, n, vec, grid, stats, q, s);
    default: return cudaErrorInvalidValue;
  }
}
