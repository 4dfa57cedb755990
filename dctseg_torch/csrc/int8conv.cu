// s8 x s8 -> s32 implicit-GEMM 3D convolution with a dequantizing
// epilogue, for Hopper (sm_90a): K6 of the port.
//
// The JAX package runs this conv as an XLA op (dctseg/ops/quant.py
// conv3d_int8, jax.lax.conv_general_dilated on int8 with int32
// accumulation); there is no Pallas kernel.  PyTorch has no int8 conv3d on
// CUDA, and im2col into an int8 matmul would write the k^3-times expanded
// activation to HBM, so the port has this kernel.
//
// The function, on a contiguous NDHWC int8 input xq (N, D, H, W, Ci) and an
// int8 weight wq in the layout (Co, kd, kh, kw, Ci):
//   acc[m, co] = sum over (kd, kh, kw, ci) of xq[tap voxel, ci] * wq[co, ...]
// (zero outside the padded input), exact in int32, then
//   y = T(float(acc) * (sx * sw[co])) + T(bias[co])
// in the output dtype T, rounded after the product and after the add as
// JAX's op order does (dctseg/models/layers.py adds the bias after the
// cast).  sx is read from device memory (stats[1], written by K7), so no
// host sync sits between the quantize and the conv.
//
// int32 headroom: |acc| <= 127^2 * k^3 * Ci, below 2^31 for k = 3 up to
// Ci = 4,931; the model's widest input is 256 channels (s2d: 8 x 32).
//
// As a GEMM: M = N * D' * H' * W' output voxels, N = Co, K = k^3 * Ci,
// K ordered (tap, channel) as the weight layout.  A block computes a
// 128 x 64 tile of the output with 8 warps (4 along M x 2 along N, 32 x 32
// each) on mma.sync.m16n8k32 (s8, s32 accumulators in registers).  A and B
// tiles 64 bytes deep are gathered straight from NDHWC and from the weight
// with cp.async (zero-filling padding, stride gaps, the ragged K edge and
// rows past M or Co) into a two-stage ring in shared memory: no im2col is
// written.  The gather moves VEC bytes at a time, VEC the largest of 16, 8,
// 4 that divides Ci and both pointers (ops/quant.py plan_int8_conv); a
// VEC-byte run never crosses a tap because VEC divides Ci.
//
// Bound on the H100: operations at the int8 tensor-core rate (1,979 TOP/s)
// for the model's convs (K = 576 .. 6912).  This first kernel is the simple
// one: mma.sync, not wgmma; cp.async, not TMA; no producer warp.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;                 // bytes of K per stage
constexpr int kThreads = 256;           // 8 warps
constexpr int kPitch = kBK + 16;        // smem row bytes: 16-byte aligned,
                                        // conflict-free fragment loads
constexpr int kStages = 2;

struct Geom {
  int n, d, h, w, ci;
  int od, oh, ow, co;
  int k, sd, sh, sw, pd, ph, pw;
  int kdim;   // k^3 * ci
  int m;      // n * od * oh * ow
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC bytes from g to shared memory at s, or VEC zero bytes where !valid
template <int VEC>
__device__ __forceinline__ void cp_async_zfill(uint32_t s, const void* g,
                                               bool valid) {
  const int src = valid ? VEC : 0;
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(g), "n"(VEC), "r"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ stats,
                 const float* __restrict__ sw, const T* __restrict__ bias,
                 T* __restrict__ out, const Geom g) {
  __shared__ __align__(16) int8_t sa[kStages][kBM][kPitch];
  __shared__ __align__(16) int8_t sb[kStages][kBN][kPitch];
  // per output row of the tile: its sample's first voxel and the corner of
  // its receptive field (z, y, x of tap 0), INT_MIN/2 past M
  __shared__ int row_base[kBM], row_z[kBM], row_y[kBM], row_x[kBM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m < g.m) {
      int t = m;
      const int ox = t % g.ow; t /= g.ow;
      const int oy = t % g.oh; t /= g.oh;
      const int oz = t % g.od;
      const int nb = t / g.od;
      row_base[r] = nb * g.d * g.h * g.w;
      row_z[r] = oz * g.sd - g.pd;
      row_y[r] = oy * g.sh - g.ph;
      row_x[r] = ox * g.sw - g.pw;
    } else {
      row_base[r] = 0;
      row_z[r] = row_y[r] = row_x[r] = INT_MIN / 2;
    }
  }
  __syncthreads();

  constexpr int kChunks = kBK / VEC;             // VEC-byte runs per row
  constexpr int kRowsPerPass = kThreads / kChunks;
  const int chunk = tid % kChunks;
  const int first_row = tid / kChunks;
  const int kk2 = g.k * g.k;

  auto load_stage = [&](int stage, int k0) {
    const int kk = k0 + chunk * VEC;
    const bool k_ok = kk < g.kdim;
    const int tap = k_ok ? kk / g.ci : 0;
    const int c = kk - tap * g.ci;
    const int kd = tap / kk2;
    const int rem = tap - kd * kk2;
    const int kh = rem / g.k;
    const int kw = rem - kh * g.k;
    // A: the gathered input rows
    for (int r = first_row; r < kBM; r += kRowsPerPass) {
      const int z = row_z[r] + kd, y = row_y[r] + kh, x = row_x[r] + kw;
      const bool ok = k_ok && (unsigned)z < (unsigned)g.d &&
                      (unsigned)y < (unsigned)g.h &&
                      (unsigned)x < (unsigned)g.w;
      const int8_t* src = xq;
      if (ok)
        src = xq + ((long long)row_base[r] + ((long long)z * g.h + y) * g.w
                    + x) * g.ci + c;
      cp_async_zfill<VEC>(smem_addr(&sa[stage][r][chunk * VEC]), src, ok);
    }
    // B: the weight rows of this tile's output channels
    for (int r = first_row; r < kBN; r += kRowsPerPass) {
      const int co = n0 + r;
      const bool ok = k_ok && co < g.co;
      const int8_t* src = ok ? wq + (long long)co * g.kdim + kk : wq;
      cp_async_zfill<VEC>(smem_addr(&sb[stage][r][chunk * VEC]), src, ok);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int grp = lane >> 2, tig = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (g.kdim + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt % kStages;
    if (kt + 1 < ktiles) {
      load_stage((kt + 1) % kStages, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + grp;
        const int col = ks + tig * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&sa[stage][r][col]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&sa[stage][r + 8][col]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&sa[stage][r][col + 16]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&sa[stage][r + 8][col + 16]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nrow = wn * 32 + j * 8 + grp;
        const int col = ks + tig * 4;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&sb[stage][nrow][col]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&sb[stage][nrow][col + 16]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: scale[c] = sx * sw[c]; T(float(acc) * scale) (+ T(bias));
  // explicit _rn intrinsics so that nvcc does not contract the product and
  // the bias add into one fma, which would round once where JAX rounds
  // twice
  const float sx = stats[1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * 32 + j * 8 + tig * 2 + e;
      if (col >= g.co) continue;
      const float scale = __fmul_rn(sx, sw[col]);
      const float b = bias ? to_f32(bias[col]) : 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm * 32 + i * 16 + grp + half * 8;
          if (row >= g.m) continue;
          T y = from_f32<T>(__fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]),
                                      scale));
          if (bias) y = from_f32<T>(__fadd_rn(to_f32(y), b));
          out[(long long)row * g.co + col] = y;
        }
      }
    }
  }
}

template <typename T>
const void* pick_vec(int vec) {
  switch (vec) {
    case 16: return reinterpret_cast<const void*>(&int8_conv_kernel<T, 16>);
    case 8: return reinterpret_cast<const void*>(&int8_conv_kernel<T, 8>);
    case 4: return reinterpret_cast<const void*>(&int8_conv_kernel<T, 4>);
    default: return nullptr;
  }
}

const void* pick(int out_dtype, int vec) {
  switch (out_dtype) {
    case kF32: return pick_vec<float>(vec);
    case kBF16: return pick_vec<__nv_bfloat16>(vec);
    case kF16: return pick_vec<__half>(vec);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// args (int64, ops/quant.py _conv_launch): xq, wq, stats, sw, bias (0 for
// none), out, n, d, h, w, ci, od, oh, ow, co, k, sd, sh, sw, pd, ph, pw,
// out_dtype, vec.  xq: contiguous (n, d, h, w, ci) int8; wq: contiguous
// (co, k, k, k, ci) int8; stats: float32 [amax, sx]; sw: float32 (co,);
// bias: (co,) in the output dtype; out: contiguous (n, od, oh, ow, co).
// A vector width that does not fit ci and the pointers is refused.
extern "C" int dctseg_int8_conv3d(const int64_t* a, void* stream) {
  Geom g;
  g.n = (int)a[6]; g.d = (int)a[7]; g.h = (int)a[8]; g.w = (int)a[9];
  g.ci = (int)a[10]; g.od = (int)a[11]; g.oh = (int)a[12]; g.ow = (int)a[13];
  g.co = (int)a[14]; g.k = (int)a[15];
  g.sd = (int)a[16]; g.sh = (int)a[17]; g.sw = (int)a[18];
  g.pd = (int)a[19]; g.ph = (int)a[20]; g.pw = (int)a[21];
  const int out_dtype = (int)a[22], vec = (int)a[23];
  const long long m = (long long)a[6] * a[11] * a[12] * a[13];
  const long long kdim = a[15] * a[15] * a[15] * a[10];
  const void* kern = pick(out_dtype, vec);
  if (!kern || m < 1 || m > INT_MAX || kdim > INT_MAX || g.co < 1 ||
      g.ci % vec || a[0] % vec || a[1] % vec ||
      (long long)a[6] * a[7] * a[8] * a[9] > INT_MAX)
    return cudaErrorInvalidValue;
  g.m = (int)m;
  g.kdim = (int)kdim;
  const void* xq = reinterpret_cast<const void*>(a[0]);
  const void* wq = reinterpret_cast<const void*>(a[1]);
  const void* stats = reinterpret_cast<const void*>(a[2]);
  const void* sw = reinterpret_cast<const void*>(a[3]);
  const void* bias = reinterpret_cast<const void*>(a[4]);
  void* out = reinterpret_cast<void*>(a[5]);
  void* args[] = {&xq, &wq, &stats, &sw, &bias, &out, &g};
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((g.co + kBN - 1) / kBN));
  return cudaLaunchKernel(kern, grid, dim3(kThreads), args, 0,
                          static_cast<cudaStream_t>(stream));
}
