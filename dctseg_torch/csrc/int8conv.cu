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
// Ci = 4,931; the model's widest input is 512 channels (k = 1).
//
// As a GEMM: M = N * D' * H' * W' output voxels, N = Co, K = k^3 * Ci,
// K ordered (tap, channel) as the weight layout.
//
// Bound on the H100: operations, at the int8 tensor-core rate (1,979
// TOP/s), for every conv of the model (K = 16 .. 6,912, M >= 32,768 at
// B = 8).  Next to it, L2: an implicit GEMM loads each tap's A tile anew,
// so the input passes through L2 k^3 times, and the weight once per M
// tile.  Two routes, picked by shape in ops/quant.py plan_int8_conv:
//
// tma (Ci a multiple of 16, both pointers 16-byte aligned: every conv of
// the model).  A persistent grid, one block per SM, walks the output tiles
// on a static stride.  A tile is BM = 128 * MSUB output voxels, a
// bd x bh x bw block of one sample, by BN output channels (Co rounded up
// to a wgmma N, at most 256), so each A tile is loaded once per tap for
// all of Co.  K comes in units of one tap x a channel chunk of CK = 32, 64
// or 128 bytes: A as one box of a rank-5 tensor map over (Ci, W, H, D, N)
// at the tap's shifted corner -- TMA's zero fill of out-of-bounds
// elements is the conv's padding, its element strides the conv's stride
// -- and B as one box of a rank-3 map over (Ci, k^3, Co), both with the
// CK-byte swizzle that wgmma reads.  One producer thread keeps an S-stage
// ring in shared memory filled, with full and empty mbarriers, a stage
// holding 128 / CK units (128 bytes of K), so that small chunks do not
// cost a barrier round trip per k-step.  Two consumer warpgroups
// (registers raised by setmaxnreg, the producer's lowered) run
// wgmma.m64nBNk32.s32.s8.s8 on 64 * MSUB rows each, keep one stage's
// wgmma group in flight while they release the stage before it, and store
// the accumulators from registers, two columns a store, while the producer
// runs ahead into the next tile.  MSUB = 2 (BM = 256) where BN <= 128
// halves the weight's traffic per output voxel; at BN = 256 the
// accumulators fill the registers and MSUB = 1.  On the card the loads
// alone and the consumers alone each take ~90 % of the kernel's time at
// the model's largest conv (dctseg_torch/tools/k6_probe.py, PERF.md), so
// only a change that shrinks both gains: a halo mode that loaded A once
// per tile cut the L2 traffic 2.5x but slowed the consumers, and lost.
//
// mma_sync (any other Ci a multiple of 4, such as the ragged channel counts
// of small configs): a 128 x 64 tile per block, 8 warps of 32 x 32 on
// mma.sync.m16n8k32, its A and B tiles 64 bytes deep gathered from NDHWC
// and from the weight with cp.async (zero-filling padding, stride gaps,
// the ragged K edge and rows past M or Co) into a two-stage ring: no
// im2col is written.  The gather moves VEC bytes at a time, VEC the
// largest of 16, 8, 4 that divides Ci and both pointers; a VEC-byte run
// never crosses a tap because VEC divides Ci.

#include <cuda.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "wgmma_s8.cuh"

namespace dctseg {
namespace {

// ---- route mma_sync ----

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
mma_sync_conv_kernel(const int8_t* __restrict__ xq,
                     const int8_t* __restrict__ wq,
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
    case 16: return reinterpret_cast<const void*>(&mma_sync_conv_kernel<T, 16>);
    case 8: return reinterpret_cast<const void*>(&mma_sync_conv_kernel<T, 8>);
    case 4: return reinterpret_cast<const void*>(&mma_sync_conv_kernel<T, 4>);
    default: return nullptr;
  }
}

const void* pick_mma_sync(int out_dtype, int vec) {
  switch (out_dtype) {
    case kF32: return pick_vec<float>(vec);
    case kBF16: return pick_vec<__nv_bfloat16>(vec);
    case kF16: return pick_vec<__half>(vec);
    default: return nullptr;
  }
}

// ---- route tma ----

constexpr int kWarpgroup = 128;
constexpr int kTmaThreads = 3 * kWarpgroup;    // 2 consumer warpgroups, then
                                               // the producer's
constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 12;                 // ops/quant.py MAX_STAGES
constexpr int kSmemBytes = 232448;             // dynamic shared memory cap
constexpr int kSmemAlign = 1024;               // the 128-byte swizzle's atom

struct TmaGeom {
  int od, oh, ow, co;
  int bd, bh, bw;           // output voxels of one M tile along z, y, x
  int nbz, nby, nbx;        // M tiles of one sample along z, y, x
  int n_tiles;              // tiles of BN output channels
  int tiles;                // n * nbz * nby * nbx * n_tiles
  int k, chunks, ck;        // ck: bytes of one chunk of a tap's channels
  int units;                // (tap, chunk) units of K: k^3 * chunks
  int group;                // units per stage
  int sd, sh, sw, pd, ph, pw;
  int stages;
  int layout;               // wgmma descriptor swizzle: 1 = 128 B, 2 = 64 B,
                            // 3 = 32 B
};

struct Tile {
  int nb, z0, y0, x0, n0;   // sample, output block corner, first channel
};

// tiles in order: channel tiles fastest, then x, y, z blocks, then samples
__device__ __forceinline__ Tile tile_at(const TmaGeom& g, int t, int bn) {
  Tile r;
  r.n0 = (t % g.n_tiles) * bn;
  t /= g.n_tiles;
  r.x0 = (t % g.nbx) * g.bw;
  t /= g.nbx;
  r.y0 = (t % g.nby) * g.bh;
  t /= g.nby;
  r.z0 = (t % g.nbz) * g.bd;
  r.nb = t / g.nbz;
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// K-major operand in shared memory, rows of ck bytes swizzled by TMA in
// atoms of 8 rows: start address, LBO (unused for swizzled K-major: 1),
// SBO = one atom, the swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulators above a wait
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, T a, T b) {
  Pack<T, 2> v;
  v.v[0] = a;
  v.v[1] = b;
  *reinterpret_cast<Pack<T, 2>*>(p) = v;
}

// a[t] of quad lane q is entry (q, t) of a 4 x 4 matrix; afterwards a[t] is
// entry (t, q): two butterfly exchanges, across lane bit 0 then bit 1
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int q) {
  const bool odd = q & 1, high = q & 2;
#pragma unroll
  for (int t = 0; t < 4; t += 2) {
    const uint32_t r =
        __shfl_xor_sync(0xffffffffu, odd ? a[t] : a[t + 1], 1);
    if (odd) {
      a[t] = r;
    } else {
      a[t + 1] = r;
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint32_t r =
        __shfl_xor_sync(0xffffffffu, high ? a[t] : a[t + 2], 2);
    if (high) {
      a[t] = r;
    } else {
      a[t + 2] = r;
    }
  }
}

// 8 consecutive columns from the quad-transposed words: word w of lane
// s's pair is columns 2s + w (f32) or 2s, 2s + 1 (16-bit types)
template <typename T>
__device__ __forceinline__ void store_block(T* p, const uint32_t (&v)[1][4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0][0], v[0][1], v[0][2],
                                            v[0][3]);
}

__device__ __forceinline__ void store_block(float* p,
                                            const uint32_t (&v)[2][4]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(v[0][0], v[1][0], v[0][1], v[1][1]);
  q[1] = make_uint4(v[0][2], v[1][2], v[0][3], v[1][3]);
}

template <typename T, int BN, int MSUB>
__global__ void __launch_bounds__(kTmaThreads, 1)
tma_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ stats,
                const float* __restrict__ sw, const T* __restrict__ bias,
                T* __restrict__ out, const TmaGeom g) {
  constexpr int kRows = 128 * MSUB;             // BM
  extern __shared__ uint8_t smem[];
  // stage s: the A boxes of its units, then their B boxes
  const uint32_t base =
      (smem_addr(smem) + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
  const uint32_t a_box = kRows * g.ck, b_box = BN * g.ck;
  const uint32_t b_first = g.group * a_box;
  const uint32_t stage_bytes = g.group * (a_box + b_box);
  const uint32_t full0 = base + g.stages * stage_bytes;   // full[s]: 8 s
  const uint32_t empty0 = full0 + 8 * g.stages;           // empty[s]: 8 s
  const int stages_per_tile = (g.units + g.group - 1) / g.group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWarpgroup) {
    // ---- producer: one thread issues every load, units in order: tap
    // (kd, kh, kw) by tap, chunk c by chunk within it, stepped by counters
    // and not divided out per unit: a small stage is a few hundred cycles
    // of wgmma, and this one thread has to keep pace with it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * kWarpgroup) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile tl = tile_at(g, t, BN);
        const int z = tl.z0 * g.sd - g.pd, y = tl.y0 * g.sh - g.ph,
                  x = tl.x0 * g.sw - g.pw;
        int tap = 0, kd = 0, kh = 0, kw = 0, c = 0;
        for (int u0 = 0; u0 < g.units; u0 += g.group) {
          const int n = min(g.group, g.units - u0);
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sa = base + stage * stage_bytes;
          mbar_expect_tx(full, n * (a_box + b_box));
          for (int j = 0; j < n; ++j) {
            tma_load_5d(sa + j * a_box, &xmap, full, c * g.ck, x + kw,
                        y + kh, z + kd, tl.nb);
            tma_load_3d(sa + b_first + j * b_box, &wmap, full, c * g.ck,
                        tap, tl.n0);
            if (++c == g.chunks) {
              c = 0;
              ++tap;
              if (++kw == g.k) {
                kw = 0;
                if (++kh == g.k) {
                  kh = 0;
                  ++kd;
                }
              }
            }
          }
          if (++stage == g.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes rows [wg, wg + 1) * 64 * MSUB
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / kWarpgroup;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int acc[MSUB][BN / 2];
#pragma unroll
    for (int i = 0; i < MSUB; ++i)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0;
    // descriptors: rows of ck bytes in 8-row swizzle atoms; m64 block i
    // i * 64 rows down, k-step ks 32 bytes into the row
    const uint32_t sbo = 8 * g.ck;
    const int ksteps = g.ck / 32;
    const uint32_t i_step = 4 * g.ck;          // 64 rows in 16-byte units
    const float sx = stats[1];
    const bool even_co = (g.co & 1) == 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int prev = 0;
      for (int st = 0; st < stages_per_tile; ++st) {
        const int n = min(g.group, g.units - st * g.group);
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = base + stage * stage_bytes;
        const uint64_t da =
            smem_desc(sa + wg * 64 * MSUB * g.ck, sbo, g.layout);
        const uint64_t db = smem_desc(sa + b_first, sbo, g.layout);
        wgmma_fence();
        for (int j = 0; j < n; ++j) {
          for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
            for (int i = 0; i < MSUB; ++i)
              Wgmma<BN>::mma(acc[i],
                             da + (j * a_box >> 4) + i * i_step + 2 * ks,
                             db + (j * b_box >> 4) + 2 * ks, st | j | ks);
          }
        }
        wgmma_commit();
        if (st > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == g.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MSUB; ++i) fence_regs(acc[i]);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // epilogue: scale[c] = sx * sw[c]; T(float(acc) * scale) (+ T(bias)),
      // with the _rn intrinsics so that nvcc does not contract the product
      // and the bias add into one fma, which would round once where JAX
      // rounds twice
      const Tile tl = tile_at(g, t, BN);
      long long row_at[MSUB][2];     // the row's first output element, or -1
#pragma unroll
      for (int i = 0; i < MSUB; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wg * MSUB + i) * 64 + warp * 16 + h * 8 + lane / 4;
          const int z = tl.z0 + r / (g.bw * g.bh);
          const int y = tl.y0 + (r / g.bw) % g.bh;
          const int x = tl.x0 + r % g.bw;
          row_at[i][h] =
              z < g.od && y < g.oh && x < g.ow
                  ? (((long long)(tl.nb * g.od + z) * g.oh + y) * g.ow + x) *
                        g.co
                  : -1;
        }
      // Each lane holds two columns of every 8-column block.  Where Co is a
      // multiple of 8, a 4 x 4 transpose of 32-bit words across the quad
      // gives each lane a whole block (16 or 32 bytes) of its row: a
      // warp's store covers 8 rows x 64 contiguous bytes, not 8 x 16.
      constexpr int kWords = sizeof(T) * 2 / 4;    // per column pair
      const int q = lane % 4;
      const bool wide = g.co % 8 == 0;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 4) {
        uint32_t v[MSUB][2][kWords][4];   // [i][h][word][block j0 + jj]
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = tl.n0 + 8 * (j0 + jj) + 2 * q;
          const bool one = col < g.co, two = col + 1 < g.co;
          const float s0 = one ? __fmul_rn(sx, sw[col]) : 0.0f;
          const float s1 = two ? __fmul_rn(sx, sw[col + 1]) : 0.0f;
          const float b0 = bias && one ? to_f32(bias[col]) : 0.0f;
          const float b1 = bias && two ? to_f32(bias[col + 1]) : 0.0f;
#pragma unroll
          for (int i = 0; i < MSUB; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = 4 * (j0 + jj) + 2 * h;
              Pack<T, 2> y;
              y.v[0] = from_f32<T>(__fmul_rn(__int2float_rn(acc[i][e]), s0));
              y.v[1] =
                  from_f32<T>(__fmul_rn(__int2float_rn(acc[i][e + 1]), s1));
              if (bias) {
                y.v[0] = from_f32<T>(__fadd_rn(to_f32(y.v[0]), b0));
                y.v[1] = from_f32<T>(__fadd_rn(to_f32(y.v[1]), b1));
              }
              uint32_t words[kWords];
              memcpy(words, &y, sizeof(y));
#pragma unroll
              for (int w = 0; w < kWords; ++w) v[i][h][w][jj] = words[w];
              if (!wide && one && row_at[i][h] >= 0) {
                T* p = out + row_at[i][h] + col;
                if (two && even_co) {
                  store_pair(p, y.v[0], y.v[1]);
                } else {
                  p[0] = y.v[0];
                  if (two) p[1] = y.v[1];
                }
              }
            }
        }
        if (wide) {
          const int col = tl.n0 + 8 * (j0 + q);
#pragma unroll
          for (int i = 0; i < MSUB; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int w = 0; w < kWords; ++w) quad_transpose(v[i][h][w], q);
              if (col < g.co && row_at[i][h] >= 0)
                store_block(out + row_at[i][h] + col, v[i][h]);
            }
        }
      }
    }
  }
}

template <typename T>
const void* pick_tma_n(int bn, int msub) {
  if (bn == 32 && msub == 2)
    return reinterpret_cast<const void*>(&tma_conv_kernel<T, 32, 2>);
  if (bn == 64 && msub == 2)
    return reinterpret_cast<const void*>(&tma_conv_kernel<T, 64, 2>);
  if (bn == 128 && msub == 2)
    return reinterpret_cast<const void*>(&tma_conv_kernel<T, 128, 2>);
  if (bn == 256 && msub == 1)
    return reinterpret_cast<const void*>(&tma_conv_kernel<T, 256, 1>);
  return nullptr;
}

const void* pick_tma(int out_dtype, int bn, int msub) {
  switch (out_dtype) {
    case kF32: return pick_tma_n<float>(bn, msub);
    case kBF16: return pick_tma_n<__nv_bfloat16>(bn, msub);
    case kF16: return pick_tma_n<__half>(bn, msub);
    default: return nullptr;
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime: the library
// links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// the tma route from the int64 args (see dctseg_int8_conv3d)
int launch_tma(const int64_t* a, cudaStream_t stream) {
  const long long n = a[6], d = a[7], h = a[8], w = a[9], ci = a[10];
  const int out_dtype = (int)a[22];
  const int bd = (int)a[25], bh = (int)a[26], bw = (int)a[27];
  const int ck = (int)a[28], bn = (int)a[29], msub = (int)a[30];
  const int group = (int)a[31], stages = (int)a[32], grid = (int)a[33];
  TmaGeom g;
  g.od = (int)a[11]; g.oh = (int)a[12]; g.ow = (int)a[13]; g.co = (int)a[14];
  g.k = (int)a[15];
  g.sd = (int)a[16]; g.sh = (int)a[17]; g.sw = (int)a[18];
  g.pd = (int)a[19]; g.ph = (int)a[20]; g.pw = (int)a[21];
  g.bd = bd; g.bh = bh; g.bw = bw; g.ck = ck; g.stages = stages;
  const void* kern = pick_tma(out_dtype, bn, msub);
  // a stage: the A and B boxes of group units
  const long long smem =
      kSmemAlign +
      (long long)stages * ((128LL * msub + bn) * ck * group + 16);
  if (!kern || ci % 16 || a[0] % 16 || a[1] % 16 || g.co < 1 || g.k < 1 ||
      (ck != 32 && ck != 64 && ck != 128) || group < 1 || group > 4 ||
      !pow2(bd) || !pow2(bh) ||
      !pow2(bw) || (long long)bd * bh * bw != 128LL * msub ||
      g.sd < 1 || g.sd > 8 || g.sh < 1 || g.sh > 8 || g.sw < 1 ||
      g.sw > 8 || bd * g.sd > 256 || bh * g.sh > 256 || bw * g.sw > 256 ||
      stages < 2 || stages > kMaxStages || smem > kSmemBytes || grid < 1 ||
      g.od < 1 || g.oh < 1 || g.ow < 1 ||
      n * d * h * w * ci > ((1LL << 40) - 1))
    return cudaErrorInvalidValue;
  g.nbz = (g.od + bd - 1) / bd;
  g.nby = (g.oh + bh - 1) / bh;
  g.nbx = (g.ow + bw - 1) / bw;
  g.n_tiles = (g.co + bn - 1) / bn;
  const long long tiles = n * g.nbz * g.nby * g.nbx * g.n_tiles;
  if (tiles > INT_MAX || grid > tiles) return cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  g.chunks = (int)((ci + ck - 1) / ck);
  g.units = g.k * g.k * g.k * g.chunks;
  g.group = group;
  g.layout = ck == 128 ? 1 : ck == 64 ? 2 : 3;
  const CUtensorMapSwizzle swizzle =
      ck == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : ck == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;

  EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorInitializationError;
  // A: (Ci, W, H, D, N) bytes; a box is ck channels of a bd x bh x bw
  // block of output voxels, traversed at the conv's stride
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[5] = {(cuuint64_t)ci, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t xstride[4] = {(cuuint64_t)ci, (cuuint64_t)(w * ci),
                                 (cuuint64_t)(h * w * ci),
                                 (cuuint64_t)(d * h * w * ci)};
  const cuuint32_t xbox[5] = {(cuuint32_t)ck, (cuuint32_t)(bw * g.sw),
                              (cuuint32_t)(bh * g.sh),
                              (cuuint32_t)(bd * g.sd), 1};
  const cuuint32_t xstep[5] = {1, (cuuint32_t)g.sw, (cuuint32_t)g.sh,
                               (cuuint32_t)g.sd, 1};
  // B: (Ci, k^3, Co) bytes; a box is ck channels of one tap for bn rows
  const int taps = g.k * g.k * g.k;
  const cuuint64_t wdim[3] = {(cuuint64_t)ci, (cuuint64_t)taps,
                              (cuuint64_t)g.co};
  const cuuint64_t wstride[2] = {(cuuint64_t)ci, (cuuint64_t)(taps * ci)};
  const cuuint32_t wbox[3] = {(cuuint32_t)ck, 1, (cuuint32_t)bn};
  const cuuint32_t wstep[3] = {1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5,
             reinterpret_cast<void*>(a[0]), xdim, xstride, xbox, xstep,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
             reinterpret_cast<void*>(a[1]), wdim, wstride, wbox, wstep,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const void* stats = reinterpret_cast<const void*>(a[2]);
  const void* sw = reinterpret_cast<const void*>(a[3]);
  const void* bias = reinterpret_cast<const void*>(a[4]);
  void* out = reinterpret_cast<void*>(a[5]);
  void* args[] = {&xmap, &wmap, &stats, &sw, &bias, &out, &g};
  // The tensor maps travel by value as __grid_constant__ arguments and
  // nothing else changes per call (the pointers aside): a CUDA graph may
  // capture this launch and replay it.
  return cudaLaunchKernel(kern, dim3(grid), dim3(kTmaThreads), args,
                          (size_t)smem, stream);
}

// the mma_sync route from the int64 args
int launch_mma_sync(const int64_t* a, cudaStream_t stream) {
  Geom g;
  g.n = (int)a[6]; g.d = (int)a[7]; g.h = (int)a[8]; g.w = (int)a[9];
  g.ci = (int)a[10]; g.od = (int)a[11]; g.oh = (int)a[12]; g.ow = (int)a[13];
  g.co = (int)a[14]; g.k = (int)a[15];
  g.sd = (int)a[16]; g.sh = (int)a[17]; g.sw = (int)a[18];
  g.pd = (int)a[19]; g.ph = (int)a[20]; g.pw = (int)a[21];
  const int out_dtype = (int)a[22], vec = (int)a[24];
  const long long m = (long long)a[6] * a[11] * a[12] * a[13];
  const long long kdim = a[15] * a[15] * a[15] * a[10];
  const void* kern = pick_mma_sync(out_dtype, vec);
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
  // No host state changes per call (the pointers aside): a CUDA graph may
  // capture this launch and replay it.
  return cudaLaunchKernel(kern, grid, dim3(kThreads), args, 0, stream);
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// args (int64, ops/quant.py _conv_launch): xq, wq, stats, sw, bias (0 for
// none), out, n, d, h, w, ci, od, oh, ow, co, k, sd, sh, sw, pd, ph, pw,
// out_dtype, route (0 mma_sync, 1 tma), then mma_sync's vec, then tma's
// bd, bh, bw, ck, bn, msub, group, stages, grid (0 where the route has
// none).
// xq: contiguous (n, d, h, w, ci) int8; wq: contiguous (co, k, k, k, ci)
// int8; stats: float32 [amax, sx]; sw: float32 (co,); bias: (co,) in the
// output dtype; out: contiguous (n, od, oh, ow, co).  A plan that does not
// fit the shapes and pointers is refused.
extern "C" int dctseg_int8_conv3d(const int64_t* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a[23]) {
    case 0: return launch_mma_sync(a, s);
    case 1: return launch_tma(a, s);
    default: return cudaErrorInvalidValue;
  }
}
