// Threshold counts of the HD95 order-statistic search, for Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/orderstats.py _count_leq
// (_count_kernel): for every class c and cut point t of a (C, M) float32
// value array and a (C, T) float32 cut array,
//     out[c, t] = #{m : values[c, m] <= cuts[c, t]}      (int32).
// The m-ary search around it (dctseg_torch/ops/orderstats.py) stays torch
// ops on (C, K, S) tensors; one launch per search pass.
//
// Bound on the H100: bytes.  A pass reads the values once (4*C*M bytes) and
// does T compares per value; at T = 14 that is 3.5 compare-and-adds per
// byte, below what the f32 lanes do per byte of HBM.  Design: a grid of
// (chunk, class) blocks walks the class's row with 16-byte loads (float4),
// neighbouring threads on neighbouring addresses, grid-stride.  The T <= 32
// cut points of the class sit in registers, padded with NaN (never <=), and
// each thread keeps T int counters.  A block sums its counters through warp
// shuffles and shared memory and makes one atomicAdd per cut into the
// zeroed output: integer atomics give the exact count in any order.  Rows
// whose length is not a multiple of 4 take a scalar-load instantiation.

#include <math.h>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerClass = 512;

template <int TM, bool VEC>
__global__ void __launch_bounds__(kThreads)
count_leq_kernel(const float* __restrict__ values,
                 const float* __restrict__ cuts, int* __restrict__ out,
                 long M, int T) {
  __shared__ int partial[kWarps][TM];
  const int c = blockIdx.y;
  const float* v = values + (long)c * M;
  float cut[TM];
  int cnt[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    cut[t] = t < T ? cuts[(long)c * T + t] : __int_as_float(0x7fc00000);
    cnt[t] = 0;
  }
  const long stride = (long)gridDim.x * kThreads;
  const long first = (long)blockIdx.x * kThreads + threadIdx.x;
  if (VEC) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (long i = first; i < M / 4; i += stride) {
      const float4 q = __ldg(v4 + i);
#pragma unroll
      for (int t = 0; t < TM; ++t)
        cnt[t] += (q.x <= cut[t]) + (q.y <= cut[t]) + (q.z <= cut[t]) +
                  (q.w <= cut[t]);
    }
  } else {
    for (long i = first; i < M; i += stride) {
      const float q = __ldg(v + i);
#pragma unroll
      for (int t = 0; t < TM; ++t) cnt[t] += q <= cut[t];
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    int s = cnt[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) partial[warp][t] = s;
  }
  __syncthreads();
  if (threadIdx.x < T) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][threadIdx.x];
    if (s) atomicAdd(out + (long)c * T + threadIdx.x, s);
  }
}

template <int TM>
cudaError_t launch(const void* values, const void* cuts, void* out, int c,
                   long m, int t, cudaStream_t stream) {
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<unsigned long>(values) % 16 == 0;
  const long items = vec ? m / 4 : m;
  long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerClass) blocks = kMaxBlocksPerClass;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)c);
  const float* v = static_cast<const float*>(values);
  const float* k = static_cast<const float*>(cuts);
  int* o = static_cast<int*>(out);
  if (vec)
    count_leq_kernel<TM, true><<<grid, kThreads, 0, stream>>>(v, k, o, m, t);
  else
    count_leq_kernel<TM, false><<<grid, kThreads, 0, stream>>>(v, k, o, m, t);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// out must hold C * T zeros.
extern "C" int dctseg_count_leq(const void* values, const void* cuts,
                                void* out, int c, long m, int t,
                                void* stream) {
  if (c < 1 || c > 65535 || m < 0 || t < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t <= 8) return launch<8>(values, cuts, out, c, m, t, st);
  if (t <= 16) return launch<16>(values, cuts, out, c, m, t, st);
  if (t <= 32) return launch<32>(values, cuts, out, c, m, t, st);
  return cudaErrorInvalidValue;
}
