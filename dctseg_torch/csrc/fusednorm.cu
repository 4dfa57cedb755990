// Fused InstanceNorm + activation (+ residual), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/fusednorm.py
// fused_instance_norm_act (stats pass _stats_kernel, apply pass
// _apply_kernel / _apply_res_kernel) and computes what that kernel
// computes: per (sample, fine channel) f32 sum and sum of squares over all
// spatial positions, var = max(E[x^2] - mean^2, 0), a = 1/sqrt(var + eps),
// b = -mean * a; then y = act(x * a + b) in f32, cast to the output dtype,
// then + residual in the output dtype.  Lane o*F + c of a C = O*F wide
// channel axis belongs to fine channel c (the s2d views of the JAX package).
//
// Layout: x, residual and out are contiguous (N, S, C) -- channels last,
// the NDHWC layout of the port's activations.
//
// Bound on the H100: memory, at a few flops per byte.  The function must
// read x once and write the output once (plus one read of the residual);
// the two-pass algorithm reads x a second time, so the kernel moves 3
// tensor passes, 4 with a residual.  What the design does about it:
//   * Every load and store moves 16 bytes per thread where C allows it
//     (8 bf16 or 4 f32 lanes), neighbouring threads on neighbouring
//     addresses; a thread keeps one fixed group of channel lanes, so its
//     partial sums stay in registers.
//   * The TPU grid carried its sum across sequential spatial tiles.  Hopper
//     blocks run in no order, so the stats pass splits the spatial axis of
//     each sample over many blocks (enough to fill 132 SMs even at 16
//     channels, where one block per (n, c) would leave most SMs idle); each
//     block writes its per-lane partial sums, and the last block of a sample
//     to finish (an atomic ticket, no float atomics) folds the partials in
//     split order, folds the s2d offsets and writes a and b.  The result is
//     deterministic: the order of every f32 sum is fixed.
//   * The apply pass reads a and b for its sample into shared memory once
//     per block and streams x (and the residual) in one read and one write.

#include <stdint.h>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, float* __restrict__ ab,
             float* __restrict__ partial, unsigned int* __restrict__ counter,
             long S, int C, int F, int splits, long rows_per_split, float eps) {
  extern __shared__ float smem[];
  __shared__ bool is_last;
  const int n = blockIdx.y;
  const int split = blockIdx.x;
  const int tid = threadIdx.x;
  const int groups = C / VEC;          // lane groups per row
  const int rpi = kThreads / groups;   // rows per iteration of the block
  const bool active = tid < rpi * groups;
  const int g = tid % groups;
  const int r0 = tid / groups;

  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if (active) {
    const long row_begin = (long)split * rows_per_split;
    const long row_end = min(S, row_begin + rows_per_split);
    const T* xn = x + (long)n * S * C + g * VEC;
    for (long row = row_begin + r0; row < row_end; row += rpi) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(xn + row * C);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(p.v[j]);
        s[j] += f;
        q[j] += f * f;
      }
    }
  }
  // smem holds [rpi][C] sums then [rpi][C] squares: thread tid = r0*groups+g
  // owns lanes g*VEC .. g*VEC+VEC-1 of row r0.
  float* ssum = smem;
  float* ssq = smem + rpi * C;
  if (active) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      ssum[tid * VEC + j] = s[j];
      ssq[tid * VEC + j] = q[j];
    }
  }
  __syncthreads();
  float* pout = partial + ((long)n * splits + split) * 2 * C;
  for (int l = tid; l < C; l += kThreads) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rpi; ++r) {
      a += ssum[r * C + l];
      b += ssq[r * C + l];
    }
    pout[l] = a;
    pout[C + l] = b;
  }
  // Publish this block's partials, then take a ticket: the block that
  // draws the last one for sample n finishes the statistics.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counter[n], 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const int O = C / F;
  const float cnt = (float)(S * (long)O);
  const float* pn = partial + (long)n * splits * 2 * C;
  for (int f = tid; f < F; f += kThreads) {
    float a = 0.f, b = 0.f;
    for (int o = 0; o < O; ++o) {
      const int l = o * F + f;
      float la = 0.f, lb = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        la += __ldcg(pn + (long)sp * 2 * C + l);
        lb += __ldcg(pn + (long)sp * 2 * C + C + l);
      }
      a += la;
      b += lb;
    }
    const float mean = a / cnt;
    const float var = fmaxf(b / cnt - mean * mean, 0.f);
    const float scale = 1.f / sqrtf(var + eps);
    const float shift = -mean * scale;
    for (int o = 0; o < O; ++o) {
      ab[(long)n * 2 * C + o * F + f] = scale;
      ab[(long)n * 2 * C + C + o * F + f] = shift;
    }
  }
}

enum Act : int { kNone = 0, kRelu = 1, kLrelu = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float y, float slope) {
  if (ACT == kRelu) return y > 0.f ? y : 0.f;
  if (ACT == kLrelu) return y >= 0.f ? y : slope * y;
  return y;
}

template <typename T, int VEC, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ ab,
             const T* __restrict__ res, T* __restrict__ out, long S, int C,
             float slope) {
  extern __shared__ float sab[];   // [C] scales, then [C] shifts
  const int n = blockIdx.y;
  for (int l = threadIdx.x; l < 2 * C; l += kThreads)
    sab[l] = ab[(long)n * 2 * C + l];
  __syncthreads();
  const int groups = C / VEC;
  const long total = S * groups;   // packs in sample n
  const long base = (long)n * S * C;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kThreads) {
    const int c0 = (int)(i % groups) * VEC;
    const long off = base + i * VEC;
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
    Pack<T, VEC> o;
    if (RES) {
      const Pack<T, VEC> r = *reinterpret_cast<const Pack<T, VEC>*>(res + off);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float y = to_f32(p.v[j]) * sab[c0 + j] + sab[C + c0 + j];
        const T yc = from_f32<T>(activate<ACT>(y, slope));
        o.v[j] = from_f32<T>(to_f32(yc) + to_f32(r.v[j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float y = to_f32(p.v[j]) * sab[c0 + j] + sab[C + c0 + j];
        o.v[j] = from_f32<T>(activate<ACT>(y, slope));
      }
    }
    *reinterpret_cast<Pack<T, VEC>*>(out + off) = o;
  }
}

template <typename T, int VEC>
cudaError_t launch_stats(const void* x, void* ab, void* partial, void* counter,
                         int n, long s, int c, int f, int splits,
                         long rows_per_split, float eps, cudaStream_t stream) {
  const int groups = c / VEC;
  const int rpi = kThreads / groups;
  const size_t smem = 2 * (size_t)rpi * c * sizeof(float);
  // at most 2 * kThreads * VEC floats (16 KB): no opt-in above 48 KB needed
  stats_kernel<T, VEC><<<dim3(splits, n), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ab),
      static_cast<float*>(partial), static_cast<unsigned int*>(counter), s, c,
      f, splits, rows_per_split, eps);
  return cudaGetLastError();
}

template <typename T, int VEC, int ACT>
cudaError_t launch_apply_act(const void* x, const void* ab, const void* res,
                             void* out, int n, long s, int c, float slope,
                             cudaStream_t stream) {
  const long total = s * (c / VEC);
  long blocks = (total + kThreads - 1) / kThreads;
  const long cap = (2048 + n - 1) / n;   // ~16 blocks per SM in all
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, n);
  const size_t smem = 2 * (size_t)c * sizeof(float);   // <= 16 KB
  if (res) {
    apply_kernel<T, VEC, ACT, true><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(ab),
        static_cast<const T*>(res), static_cast<T*>(out), s, c, slope);
  } else {
    apply_kernel<T, VEC, ACT, false><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(ab), nullptr,
        static_cast<T*>(out), s, c, slope);
  }
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_apply(const void* x, const void* ab, const void* res,
                         void* out, int n, long s, int c, int act, float slope,
                         cudaStream_t stream) {
  switch (act) {
    case kNone:
      return launch_apply_act<T, VEC, kNone>(x, ab, res, out, n, s, c, slope, stream);
    case kRelu:
      return launch_apply_act<T, VEC, kRelu>(x, ab, res, out, n, s, c, slope, stream);
    case kLrelu:
      return launch_apply_act<T, VEC, kLrelu>(x, ab, res, out, n, s, c, slope, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// vec is 16 bytes' worth of lanes where the wrapper found C divisible by it
// and every pointer 16-byte aligned, else 1.  The wrapper also guarantees
// C / vec <= 256 and F | C.

extern "C" int dctseg_fusednorm_stats(const void* x, void* ab, void* partial,
                                      void* counter, int n, long s, int c,
                                      int f, int splits, long rows_per_split,
                                      float eps, int dtype, int vec,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && vec == 4)
    return launch_stats<float, 4>(x, ab, partial, counter, n, s, c, f, splits, rows_per_split, eps, st);
  if (dtype == kF32 && vec == 1)
    return launch_stats<float, 1>(x, ab, partial, counter, n, s, c, f, splits, rows_per_split, eps, st);
  if (dtype == kBF16 && vec == 8)
    return launch_stats<__nv_bfloat16, 8>(x, ab, partial, counter, n, s, c, f, splits, rows_per_split, eps, st);
  if (dtype == kBF16 && vec == 1)
    return launch_stats<__nv_bfloat16, 1>(x, ab, partial, counter, n, s, c, f, splits, rows_per_split, eps, st);
  if (dtype == kF16 && vec == 8)
    return launch_stats<__half, 8>(x, ab, partial, counter, n, s, c, f, splits, rows_per_split, eps, st);
  if (dtype == kF16 && vec == 1)
    return launch_stats<__half, 1>(x, ab, partial, counter, n, s, c, f, splits, rows_per_split, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" int dctseg_fusednorm_apply(const void* x, const void* ab,
                                      const void* res, void* out, int n,
                                      long s, int c, int act, float slope,
                                      int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && vec == 4)
    return launch_apply<float, 4>(x, ab, res, out, n, s, c, act, slope, st);
  if (dtype == kF32 && vec == 1)
    return launch_apply<float, 1>(x, ab, res, out, n, s, c, act, slope, st);
  if (dtype == kBF16 && vec == 8)
    return launch_apply<__nv_bfloat16, 8>(x, ab, res, out, n, s, c, act, slope, st);
  if (dtype == kBF16 && vec == 1)
    return launch_apply<__nv_bfloat16, 1>(x, ab, res, out, n, s, c, act, slope, st);
  if (dtype == kF16 && vec == 8)
    return launch_apply<__half, 8>(x, ab, res, out, n, s, c, act, slope, st);
  if (dtype == kF16 && vec == 1)
    return launch_apply<__half, 1>(x, ab, res, out, n, s, c, act, slope, st);
  return cudaErrorInvalidValue;
}

// The message of an error code returned by any entry of the library
// (ops/_build.py check()).
extern "C" const char* dctseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
