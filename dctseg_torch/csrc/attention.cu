// Fused attention forward, softmax(q k^T * scale) v, for Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/attention.py fused_attention
// (_fused_attention_impl running _attn_kernel): for each (batch, head) the
// scores, the softmax and p.v are computed in f32 and only the output, in
// q's dtype, is written.  p stays f32 into p.v (the Pallas kernel's
// semantics; the JAX package's einsum path casts p to the input dtype
// first).
//
// Layout: q (BH, N, D), k and v (BH, N2, D), all contiguous, one dtype.
// D <= 128; K and V of one (b, h) must fit shared memory together.
//
// Bound on the H100: bytes on paper, latency in fact.  At the model's shape
// (B=8, H=8, N=N2=129, D=64) one call reads q, k, v and writes the output,
// 4.2 MB in bf16, and does 0.27 GFLOP: both bounds are around a
// microsecond, far below what a launch and the serial per-query work take
// (PERF.md has the card's numbers).  What the design does about that: it is
// one launch; one block per
// (b, h) and tile of 32 queries (320 blocks at the model's shape, one wave on
// 132 SMs); K and V of the (b, h) are staged once into shared memory in f32
// (K rows padded by one word so that the 32 lanes of a warp, each on its own
// key, hit 32 banks); each warp then takes one query at a time: lanes split
// the keys for the scores and the head dimension for p.v, and the row max
// and sum are warp shuffles.  No tensor cores (wgmma) yet: at this size
// they would not move the time.

#include <math.h>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int N, int N2,
                 int D, float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;                       // padded K row stride
  float* Ks = smem;                           // [N2][D + 1]
  float* Vs = Ks + (size_t)N2 * ks;           // [N2][D]
  float* Qs = Vs + (size_t)N2 * D;            // [kWarps][D]
  float* Ps = Qs + kWarps * D;                // [kWarps][N2]

  const long bh = blockIdx.y;
  const T* kb = k + bh * N2 * D;
  const T* vb = v + bh * N2 * D;
  for (int i = threadIdx.x; i < N2 * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    Ks[j * ks + d] = to_f32(kb[i]);
    Vs[i] = to_f32(vb[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = Qs + warp * D;
  float* ps = Ps + warp * N2;
  const int q_end = min(N, (int)(blockIdx.x + 1) * kTileQ);
  for (int qi = blockIdx.x * kTileQ + warp; qi < q_end; qi += kWarps) {
    const T* qrow = q + (bh * N + qi) * D;
    for (int d = lane; d < D; d += 32) qs[d] = to_f32(qrow[d]);
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < N2; j += 32) {
      const float* kr = Ks + j * ks;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qs[d], kr[d], acc);
      acc *= scale;
      ps[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < N2; j += 32) {
      const float p = expf(ps[j] - m);
      ps[j] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int j = lane; j < N2; j += 32) ps[j] = ps[j] / l;
    __syncwarp();

    T* orow = out + (bh * N + qi) * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N2; ++j) acc = fmaf(ps[j], Vs[j * D + d], acc);
      orow[d] = from_f32<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int n, int n2, int d, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      ((size_t)n2 * (2 * d + 1) + (size_t)kWarps * (d + n2)) * sizeof(float);
  auto kernel = attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + kTileQ - 1) / kTileQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, n2, d, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

extern "C" int dctseg_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, int bh, int n,
                                    int n2, int d, float scale, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(q, k, v, out, bh, n, n2, d, scale, st);
    case kBF16: return launch<__nv_bfloat16>(q, k, v, out, bh, n, n2, d, scale, st);
    case kF16: return launch<__half>(q, k, v, out, bh, n, n2, d, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
