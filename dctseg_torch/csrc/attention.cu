// Fused attention forward, softmax(q k^T * scale) v, for Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/attention.py fused_attention
// (_fused_attention_impl running _attn_kernel): for each (batch, head) the
// scores, the softmax and p.v are computed at f32 accuracy and only the
// output, in q's dtype, is written.  p is divided by its row sum before
// p.v and stays at f32 accuracy into p.v (the Pallas kernel's semantics;
// the JAX package's einsum path casts p to the input dtype first).
//
// Layout: q (B, H, N, D), k and v (B, H, N2, D), one dtype, each with unit
// stride on D and any strides on B, H and N (the model passes views of its
// QKV projection).  The output is written as a contiguous (B, N, H, D)
// array, which the wrapper returns as a (B, H, N, D) view, so that the
// model's merge of the heads costs no copy.
//
// Two kernels, chosen by the wrapper (dctseg_torch/ops/attention.py):
//
// attention_mma_kernel, bf16 and f16, D a multiple of 16 up to 128,
// N2 <= 144, rows 16-byte aligned.  Bound on the H100: bytes on paper
// (at the model's (8, 8, 129, 64) one call moves 4.2 MB and does 0.27
// GFLOP, about a microsecond each way), latency in fact.  One block per
// (b, h, tile of 64 queries): 192 blocks at the model's shape, over the
// 132 SMs.  K and V of the (b, h) and the block's Q rows are staged once,
// in the input dtype, with 16-byte cp.async copies; keys are padded to a
// multiple of 16 with zero rows, and rows are padded by 16 bytes so that
// the eight 16-byte rows an ldmatrix reads fall on distinct banks.  Each
// warp holds 16 query rows.  S = Q K^T runs on mma.sync.m16n8k16 with f32
// accumulators (bf16 x bf16 products are exact in f32, so only the order
// of the sum differs from the plain version); padded keys are masked to
// -inf; the softmax runs on the accumulators in registers, with the row
// max and sum over the four lanes of a quad.  P.V takes p from registers
// as the A operand and V through ldmatrix.trans; p keeps f32 accuracy by
// going in as hi + lo, two 16-bit halves, in two MMAs.  The output is the
// f32 accumulator cast once.  S costs N2P / 2 registers a thread (72 at
// N2 = 129), which bounds N2.  wgmma and TMA buy nothing at 129 x 129 x 64
// per head: a warpgroup's 64-row tile and a TMA descriptor per call are
// larger than the work; mma.sync is the tool at this size.
//
// window_attention_kernel (K8), the shifted-window attention of Swin
// UNETR's encoder, bf16 and f16, D 16, 32 or 64, up to ws^3 tokens a
// window (ws <= 8; MONAI's windows are 7^3 = 343 tokens at D = 16):
// softmax(q k^T * scale + bias + mask) v for every (window, head), the
// bias gathered inside the kernel from the (2 ws - 1)^3 x H table of
// learned relative-position biases by MONAI's index formula (no
// (H, N, N) tensor is made), the shift mask (-100 where two tokens' region
// ids differ) from an (nW, N) int8 map of region ids, or none for an
// unshifted block.  Bound: the ALU and MUFU work of the N^2 scores a
// (window, head) (at D = 16 the products take a fraction of it), then the
// bytes of q, k, v read once and the output written once.  The design is
// at the kernel below.
//
// attention_simt_kernel, any dtype (the f32 instantiation, and shapes
// outside the tensor-core kernel's limits): one block per (b, h) and tile
// of 32 queries; K and V of the (b, h) are staged once into shared memory
// in f32 (K rows padded by one word so that the 32 lanes of a warp, each on
// its own key, hit 32 banks); each warp then takes one query at a time:
// lanes split the keys for the scores and the head dimension for p.v, and
// the row max and sum are warp shuffles.  No tensor cores.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace dctseg {
namespace {

struct Strides {
  long qb, qh, qn, kb, kh, kn, vb, vh, vn;
};

// ------------------------------------------------------------- SIMT kernel

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
attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int H,
                      int N, int N2, int D, Strides st, float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;                       // padded K row stride
  float* Ks = smem;                           // [N2][D + 1]
  float* Vs = Ks + (size_t)N2 * ks;           // [N2][D]
  float* Qs = Vs + (size_t)N2 * D;            // [kWarps][D]
  float* Ps = Qs + kWarps * D;                // [kWarps][N2]

  const int b = blockIdx.z, h = blockIdx.y;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  for (int i = threadIdx.x; i < N2 * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    Ks[j * ks + d] = to_f32(kb[j * st.kn + d]);
    Vs[i] = to_f32(vb[j * st.vn + d]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = Qs + warp * D;
  float* ps = Ps + warp * N2;
  const int q_end = min(N, (int)(blockIdx.x + 1) * kTileQ);
  for (int qi = blockIdx.x * kTileQ + warp; qi < q_end; qi += kWarps) {
    const T* qrow = q + b * st.qb + h * st.qh + qi * st.qn;
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

    T* orow = out + (((long)b * N + qi) * H + h) * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N2; ++j) acc = fmaf(ps[j], Vs[j * D + d], acc);
      orow[d] = from_f32<T>(acc);
    }
    __syncwarp();
  }
}

size_t simt_smem(int n2, int d) {
  return ((size_t)n2 * (2 * d + 1) + (size_t)kWarps * (d + n2)) * sizeof(float);
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int b, int h, int n, int n2, int d,
                        const Strides& st, float scale, cudaStream_t stream) {
  const size_t smem = simt_smem(n2, d);
  auto kernel = attention_simt_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + kTileQ - 1) / kTileQ, h, b);
  // No host state changes per call (the pointers aside): a CUDA graph may
  // capture this launch and replay it.
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, n, n2, d, st, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ tensor-core kernel

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16 * kMmaWarps;    // queries per block
constexpr int kMaxKey16 = 9;                // N2 <= 144: S in 72 registers
constexpr int kPad = 8;                     // elements of row padding

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two floats as a pair of 16-bit values (the lower column in the low half)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// (x0, x1) = hi + lo, each a 16-bit pair: p at f32 accuracy in two MMAs
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  const float2 h = unpack2<T>(hi);
  lo = pack2<T>(x0 - h.x, x1 - h.y);
}

template <typename T, int D16>
__global__ void __launch_bounds__(kMmaThreads)
attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int H,
                     int N, int N2, Strides st, float scale) {
  constexpr int D = D16 * 16;
  constexpr int P = D + kPad;               // shared row pitch, elements
  constexpr int kChunks = D / 8;            // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n2p = (N2 + 15) & ~15;
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [n2p][P]
  T* Vs = Ks + n2p * P;                     // [n2p][P]
  T* Qs = Vs + n2p * P;                     // [kMmaRows][P]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const int tid = threadIdx.x;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const T* qb = q + b * st.qb + h * st.qh;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < n2p * kChunks; c += kMmaThreads) {
    const int j = c / kChunks, part = (c % kChunks) * 8;
    T* kd = Ks + j * P + part;
    T* vd = Vs + j * P + part;
    if (j < N2) {
      cp_async16(kd, kb + j * st.kn + part);
      cp_async16(vd, vb + j * st.vn + part);
    } else {
      *reinterpret_cast<uint4*>(kd) = zero;
      *reinterpret_cast<uint4*>(vd) = zero;
    }
  }
  for (int c = tid; c < kMmaRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, part = (c % kChunks) * 8;
    T* qd = Qs + r * P + part;
    if (q0 + r < N)
      cp_async16(qd, qb + (q0 + r) * st.qn + part);
    else
      *reinterpret_cast<uint4*>(qd) = zero;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16;                 // the warp's first row in Qs
  if (q0 + r0 >= N) return;
  const int nk16 = n2p / 16;
  const int g = lane >> 2, t = lane & 3;    // accumulator row, column pair

  uint32_t qa[D16][4];
#pragma unroll
  for (int dk = 0; dk < D16; ++dk)
    ldmatrix_x4(qa[dk], Qs + (r0 + (lane & 15)) * P + dk * 16 + (lane >> 4) * 8);

  // S = Q K^T: s[nb] is the 16 x 8 block of keys 8 nb .. 8 nb + 7
  float s[2 * kMaxKey16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxKey16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * kk][e] = s[2 * kk + 1][e] = 0.f;
    if (kk < nk16) {
      const T* kr = Ks + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dk = 0; dk < D16; ++dk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kr + dk * 16);
        mma16816<T>(s[2 * kk], qa[dk], bf[0], bf[1]);
        mma16816<T>(s[2 * kk + 1], qa[dk], bf[2], bf[3]);
      }
    }
  }

  // softmax over the keys of rows g (s[.][0..1]) and g + 8 (s[.][2..3])
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < 2 * kMaxKey16; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool key = nb * 8 + 2 * t + e < N2;
      const float x0 = key ? s[nb][e] * scale : -INFINITY;
      const float x1 = key ? s[nb][2 + e] * scale : -INFINITY;
      s[nb][e] = x0;
      s[nb][2 + e] = x1;
      m0 = fmaxf(m0, x0);
      m1 = fmaxf(m1, x1);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < 2 * kMaxKey16; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nb][e] = expf(s[nb][e] - m0);
      s[nb][2 + e] = expf(s[nb][2 + e] - m1);
      l0 += s[nb][e];
      l1 += s[nb][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
#pragma unroll
  for (int nb = 0; nb < 2 * kMaxKey16; ++nb) {
    s[nb][0] /= l0;
    s[nb][1] /= l0;
    s[nb][2] /= l1;
    s[nb][3] /= l1;
  }

  // O = P V, p as hi + lo
  float o[2 * D16][4];
#pragma unroll
  for (int nb = 0; nb < 2 * D16; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxKey16; ++kk) {
    if (kk < nk16) {
      uint32_t ph[4], pl[4];
      split2<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const T* vr = Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                    (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < D16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vr + dp * 16);
        mma16816<T>(o[2 * dp], ph, bf[0], bf[1]);
        mma16816<T>(o[2 * dp], pl, bf[0], bf[1]);
        mma16816<T>(o[2 * dp + 1], ph, bf[2], bf[3]);
        mma16816<T>(o[2 * dp + 1], pl, bf[2], bf[3]);
      }
    }
  }

  // rows g and g + 8 of the warp's 16, into the (B, N, H, D) output
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  T* out0 = out + (((long)b * N + row0) * H + h) * D + 2 * t;
  T* out1 = out + (((long)b * N + row1) * H + h) * D + 2 * t;
#pragma unroll
  for (int nb = 0; nb < 2 * D16; ++nb) {
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(out0 + nb * 8) = pack2<T>(o[nb][0], o[nb][1]);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(out1 + nb * 8) = pack2<T>(o[nb][2], o[nb][3]);
  }
}

template <typename T, int D16>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int b, int h, int n, int n2, const Strides& st,
                       float scale, cudaStream_t stream) {
  const int n2p = (n2 + 15) & ~15;
  const size_t smem = (size_t)(2 * n2p + kMmaRows) * (D16 * 16 + kPad) * 2;
  auto kernel = attention_mma_kernel<T, D16>;
  static unsigned opted_in = 0;             // the largest size, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!((opted_in >> (dev & 31)) & 1u)) {
    const size_t most = (size_t)(2 * 16 * kMaxKey16 + kMmaRows) *
                        (D16 * 16 + kPad) * 2;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
    if (e != cudaSuccess) return e;
    opted_in |= 1u << (dev & 31);
  }
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, h, b);
  // No host state changes per call (the pointers aside): a CUDA graph may
  // capture this launch and replay it.
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, n, n2, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         void* out, int b, int h, int n, int n2, int d,
                         const Strides& st, float scale, cudaStream_t s) {
  switch (d / 16) {
    case 1: return launch_mma<T, 1>(q, k, v, out, b, h, n, n2, st, scale, s);
    case 2: return launch_mma<T, 2>(q, k, v, out, b, h, n, n2, st, scale, s);
    case 3: return launch_mma<T, 3>(q, k, v, out, b, h, n, n2, st, scale, s);
    case 4: return launch_mma<T, 4>(q, k, v, out, b, h, n, n2, st, scale, s);
    case 5: return launch_mma<T, 5>(q, k, v, out, b, h, n, n2, st, scale, s);
    case 6: return launch_mma<T, 6>(q, k, v, out, b, h, n, n2, st, scale, s);
    case 7: return launch_mma<T, 7>(q, k, v, out, b, h, n, n2, st, scale, s);
    case 8: return launch_mma<T, 8>(q, k, v, out, b, h, n, n2, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ------------------------------------------- shifted-window attention (K8)

constexpr int kWinWarps = 4;
constexpr int kWinThreads = kWinWarps * 32;
constexpr int kWinGroups = 4;             // 16-key groups per softmax chunk
constexpr int kWinMaxSide = 8;            // window side of the bias table
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -100.f;      // MONAI's shift-mask value

struct WinParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* table;       // [(2 ws - 1)^3] rows of H, strides below
  const int8_t* ids;        // [nW][N] region ids, or null (no shift mask)
  Strides st;
  long table_row, table_head;   // element strides of the bias table
  int bw, h, n, nw, ws;
  float scale;
};

// One block per (window, head): K and V of the pair staged once in shared
// memory in the input dtype (16-byte cp.async, keys padded to a multiple
// of 16 with zero rows, rows padded by 16 bytes for conflict-free
// ldmatrix), the head's column of the bias table in f32 (times log2 e),
// each key's offset into the table and, for a shifted block, its region
// id.  Each warp takes tiles of 16 queries: its Q fragments come straight
// from global memory; S = Q K^T runs on mma.sync.m16n8k16 with f32
// accumulators, 64 keys at a time, with an online softmax in the log2
// domain: s * scale * log2 e + table[base_i - off_j] (+ -100 log2 e where
// the two tokens' region ids differ), padded keys -inf.  P V takes p from
// registers as hi + lo, two 16-bit halves in two MMAs, so p keeps f32
// accuracy; the output is the f32 accumulator over the row sum, cast once.
template <typename T, int D16, bool MASK>
__global__ void __launch_bounds__(kWinThreads)
window_attention_kernel(const WinParams p) {
  constexpr int D = D16 * 16;
  constexpr int P = D + kPad;               // shared row pitch, elements
  constexpr int kChunks = D / 8;            // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.n;
  const int n2p = (N + 15) & ~15;
  const int side = 2 * p.ws - 1;
  const int rows = side * side * side;
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [n2p][P]
  T* Vs = Ks + n2p * P;                     // [n2p][P]
  float* tb = reinterpret_cast<float*>(Vs + n2p * P);   // [rows]
  int* koff = reinterpret_cast<int*>(tb + rows);        // [n2p]
  int* kid = koff + n2p;                                 // [n2p] (MASK)

  const int bw = blockIdx.x / p.h, h = blockIdx.x - bw * p.h;
  const int tid = threadIdx.x;
  const Strides& st = p.st;
  const T* kb = static_cast<const T*>(p.k) + bw * st.kb + h * st.kh;
  const T* vb = static_cast<const T*>(p.v) + bw * st.vb + h * st.vh;
  const T* qb = static_cast<const T*>(p.q) + bw * st.qb + h * st.qh;
  const int8_t* ids = MASK ? p.ids + (long)(bw % p.nw) * N : nullptr;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < n2p * kChunks; c += kWinThreads) {
    const int j = c / kChunks, part = (c % kChunks) * 8;
    T* kd = Ks + j * P + part;
    T* vd = Vs + j * P + part;
    if (j < N) {
      cp_async16(kd, kb + j * st.kn + part);
      cp_async16(vd, vb + j * st.vn + part);
    } else {
      *reinterpret_cast<uint4*>(kd) = zero;
      *reinterpret_cast<uint4*>(vd) = zero;
    }
  }
  for (int i = tid; i < rows; i += kWinThreads)
    tb[i] = __ldg(p.table + i * p.table_row + h * p.table_head) * kLog2e;
  const int ws = p.ws, ws2 = p.ws * p.ws;
  for (int j = tid; j < n2p; j += kWinThreads) {
    // key j at (j / ws^2, j / ws % ws, j % ws) of a ws^3 window (MONAI
    // indexes the first N tokens of it); a padded key reads row 0
    koff[j] = j < N ? (j / ws2) * side * side + (j / ws % ws) * side + j % ws
                    : 0;
    if (MASK) kid[j] = j < N ? ids[j] : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;    // accumulator row, column pair
  const int nk16 = n2p / 16;
  const float sc = p.scale * kLog2e;
  const float masked = kMaskValue * kLog2e;
  for (int q0 = warp * 16; q0 < N; q0 += kWinWarps * 16) {
    // the warp's Q rows q0 + g and q0 + g + 8, as mma A fragments
    const int r0 = q0 + g, r1 = r0 + 8;
    uint32_t qa[D16][4];
#pragma unroll
    for (int dk = 0; dk < D16; ++dk) {
      const int c = dk * 16 + 2 * t;
      const T* q0p = qb + (long)r0 * st.qn + c;
      const T* q1p = qb + (long)r1 * st.qn + c;
      qa[dk][0] = r0 < N ? *reinterpret_cast<const uint32_t*>(q0p) : 0u;
      qa[dk][1] = r1 < N ? *reinterpret_cast<const uint32_t*>(q1p) : 0u;
      qa[dk][2] = r0 < N ? *reinterpret_cast<const uint32_t*>(q0p + 8) : 0u;
      qa[dk][3] = r1 < N ? *reinterpret_cast<const uint32_t*>(q1p + 8) : 0u;
    }
    // the table row of (query i, key j) is base_i - off_j
    const int c0 = min(r0, N - 1), c1 = min(r1, N - 1);
    const int base0 = (c0 / ws2 + ws - 1) * side * side +
                      (c0 / ws % ws + ws - 1) * side + c0 % ws + ws - 1;
    const int base1 = (c1 / ws2 + ws - 1) * side * side +
                      (c1 / ws % ws + ws - 1) * side + c1 % ws + ws - 1;
    const int id0 = MASK ? (int)ids[c0] : 0, id1 = MASK ? (int)ids[c1] : 0;

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[2 * D16][4];
#pragma unroll
    for (int nb = 0; nb < 2 * D16; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;

    for (int g0 = 0; g0 < nk16; g0 += kWinGroups) {
      // S for keys 16 g0 .. 16 (g0 + kWinGroups): s[nb] is keys 8 nb ..
      float s[2 * kWinGroups][4];
#pragma unroll
      for (int kk = 0; kk < kWinGroups; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * kk][e] = s[2 * kk + 1][e] = 0.f;
        if (g0 + kk < nk16) {
          const T* kr = Ks + ((g0 + kk) * 16 + (lane & 7) +
                              ((lane >> 4) << 3)) * P +
                        ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int dk = 0; dk < D16; ++dk) {
            uint32_t bf[4];
            ldmatrix_x4(bf, kr + dk * 16);
            mma16816<T>(s[2 * kk], qa[dk], bf[0], bf[1]);
            mma16816<T>(s[2 * kk + 1], qa[dk], bf[2], bf[3]);
          }
        }
      }
      // scores in the log2 domain, the chunk's row max
      float cm0 = -INFINITY, cm1 = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 2 * kWinGroups; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = g0 * 16 + nb * 8 + 2 * t + e;
          float x0 = -INFINITY, x1 = -INFINITY;
          if (j < N) {
            const int off = koff[j];
            x0 = fmaf(s[nb][e], sc, tb[base0 - off]);
            x1 = fmaf(s[nb][2 + e], sc, tb[base1 - off]);
            if (MASK) {
              const int kj = kid[j];
              if (kj != id0) x0 += masked;
              if (kj != id1) x1 += masked;
            }
          }
          s[nb][e] = x0;
          s[nb][2 + e] = x1;
          cm0 = fmaxf(cm0, x0);
          cm1 = fmaxf(cm1, x1);
        }
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, sh));
        cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, sh));
      }
      const float n0 = fmaxf(m0, cm0), n1 = fmaxf(m1, cm1);
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int nb = 0; nb < 2 * D16; ++nb) {
        o[nb][0] *= a0;
        o[nb][1] *= a0;
        o[nb][2] *= a1;
        o[nb][3] *= a1;
      }
#pragma unroll
      for (int nb = 0; nb < 2 * kWinGroups; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nb][e] = exp2f(s[nb][e] - n0);
          s[nb][2 + e] = exp2f(s[nb][2 + e] - n1);
          l0 += s[nb][e];
          l1 += s[nb][2 + e];
        }
      }
      // O += P V, p as hi + lo
#pragma unroll
      for (int kk = 0; kk < kWinGroups; ++kk) {
        if (g0 + kk < nk16) {
          uint32_t ph[4], pl[4];
          split2<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split2<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
          const T* vr = Vs + ((g0 + kk) * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * P +
                        (lane >> 4) * 8;
#pragma unroll
          for (int dp = 0; dp < D16; ++dp) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, vr + dp * 16);
            mma16816<T>(o[2 * dp], ph, bf[0], bf[1]);
            mma16816<T>(o[2 * dp], pl, bf[0], bf[1]);
            mma16816<T>(o[2 * dp + 1], ph, bf[2], bf[3]);
            mma16816<T>(o[2 * dp + 1], pl, bf[2], bf[3]);
          }
        }
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    // rows r0 and r1 into the (BW, N, H, D) output
    T* out0 = static_cast<T*>(p.out) + (((long)bw * N + r0) * p.h + h) * D + 2 * t;
    T* out1 = static_cast<T*>(p.out) + (((long)bw * N + r1) * p.h + h) * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 2 * D16; ++nb) {
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(out0 + nb * 8) =
            pack2<T>(o[nb][0] * i0, o[nb][1] * i0);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(out1 + nb * 8) =
            pack2<T>(o[nb][2] * i1, o[nb][3] * i1);
    }
  }
}

size_t window_smem(int n, int d, int ws, bool mask) {
  const size_t n2p = (n + 15) & ~15;
  const size_t side = 2 * ws - 1;
  return 2 * n2p * (d + kPad) * 2 + side * side * side * 4 + n2p * 4 +
         (mask ? n2p * 4 : 0);
}

template <typename T, int D16, bool MASK>
cudaError_t launch_window(const WinParams& p, cudaStream_t stream) {
  auto kernel = window_attention_kernel<T, D16, MASK>;
  const size_t smem = window_smem(p.n, D16 * 16, p.ws, MASK);
  static unsigned opted_in = 0;             // the largest size, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!((opted_in >> (dev & 31)) & 1u)) {
    const size_t most = window_smem(kWinMaxSide * kWinMaxSide * kWinMaxSide,
                                    D16 * 16, kWinMaxSide, true);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
    if (e != cudaSuccess) return e;
    opted_in |= 1u << (dev & 31);
  }
  // No host state changes per call (the pointers aside): a CUDA graph may
  // capture this launch and replay it.
  kernel<<<p.bw * p.h, kWinThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool MASK>
cudaError_t dispatch_window(const WinParams& p, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_window<T, 1, MASK>(p, s);
    case 32: return launch_window<T, 2, MASK>(p, s);
    case 64: return launch_window<T, 4, MASK>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// args: q, k, v, out (device pointers), B, H, N, N2, D, then the element
// strides of q, k and v along B, H and N (9 values), then the dtype code
// and the kernel (0: SIMT, 1: tensor cores).  One array, so that the
// Python side passes three arguments through ctypes.
extern "C" int dctseg_attention_fwd(const int64_t* args, float scale,
                                    void* stream) {
  const void* q = reinterpret_cast<const void*>(args[0]);
  const void* k = reinterpret_cast<const void*>(args[1]);
  const void* v = reinterpret_cast<const void*>(args[2]);
  void* out = reinterpret_cast<void*>(args[3]);
  const int b = (int)args[4], h = (int)args[5], n = (int)args[6],
            n2 = (int)args[7], d = (int)args[8];
  const Strides st{args[9], args[10], args[11], args[12], args[13],
                   args[14], args[15], args[16], args[17]};
  const int dtype = (int)args[18], mma = (int)args[19];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || h > 65535 || b > 65535 || n < 1 || n2 < 1 || d < 1)
    return cudaErrorInvalidValue;
  if (mma) {
    const bool ok = dtype != kF32 && d % 16 == 0 && d <= 128 &&
                    n2 <= 16 * kMaxKey16 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && st.qb % 8 == 0 && st.qh % 8 == 0 &&
                    st.qn % 8 == 0 && st.kb % 8 == 0 && st.kh % 8 == 0 &&
                    st.kn % 8 == 0 && st.vb % 8 == 0 && st.vh % 8 == 0 &&
                    st.vn % 8 == 0;
    if (!ok) return cudaErrorInvalidValue;
    if (dtype == kBF16)
      return dispatch_mma<__nv_bfloat16>(q, k, v, out, b, h, n, n2, d, st, scale, s);
    return dispatch_mma<__half>(q, k, v, out, b, h, n, n2, d, st, scale, s);
  }
  switch (dtype) {
    case kF32: return launch_simt<float>(q, k, v, out, b, h, n, n2, d, st, scale, s);
    case kBF16: return launch_simt<__nv_bfloat16>(q, k, v, out, b, h, n, n2, d, st, scale, s);
    case kF16: return launch_simt<__half>(q, k, v, out, b, h, n, n2, d, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// Shifted-window attention (K8).  args: q, k, v, out, table, ids (device
// pointers; ids 0 for an unshifted block), BW, H, N, D, nW, ws, the 9
// element strides of q, k and v along BW, H and N, the table's strides
// along its rows and heads, and the dtype code.  q, k, v: (BW, H, N, D)
// with unit stride on D, rows on 16-byte boundaries; out: contiguous
// (BW, N, H, D); table: f32 [(2 ws - 1)^3] x H; ids: int8 [nW][N].
extern "C" int dctseg_window_attention_fwd(const int64_t* args, float scale,
                                           void* stream) {
  WinParams p;
  p.q = reinterpret_cast<const void*>(args[0]);
  p.k = reinterpret_cast<const void*>(args[1]);
  p.v = reinterpret_cast<const void*>(args[2]);
  p.out = reinterpret_cast<void*>(args[3]);
  p.table = reinterpret_cast<const float*>(args[4]);
  p.ids = reinterpret_cast<const int8_t*>(args[5]);
  p.bw = (int)args[6];
  p.h = (int)args[7];
  p.n = (int)args[8];
  const int d = (int)args[9];
  p.nw = (int)args[10];
  p.ws = (int)args[11];
  p.st = Strides{args[12], args[13], args[14], args[15], args[16],
                 args[17], args[18], args[19], args[20]};
  p.table_row = args[21];
  p.table_head = args[22];
  const int dtype = (int)args[23];
  p.scale = scale;
  const Strides& st = p.st;
  const bool ok =
      p.bw >= 1 && p.h >= 1 && (long)p.bw * p.h < (1L << 31) && p.n >= 1 &&
      p.ws >= 1 && p.ws <= kWinMaxSide && p.n <= p.ws * p.ws * p.ws &&
      p.nw >= 1 && p.bw % p.nw == 0 && (dtype == kBF16 || dtype == kF16) &&
      aligned16(p.q) && aligned16(p.k) && aligned16(p.v) && aligned16(p.out) &&
      st.qb % 8 == 0 && st.qh % 8 == 0 && st.qn % 8 == 0 && st.kb % 8 == 0 &&
      st.kh % 8 == 0 && st.kn % 8 == 0 && st.vb % 8 == 0 && st.vh % 8 == 0 &&
      st.vn % 8 == 0;
  if (!ok) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mask = p.ids != nullptr;
  if (dtype == kBF16)
    return mask ? dispatch_window<__nv_bfloat16, true>(p, d, s)
                : dispatch_window<__nv_bfloat16, false>(p, d, s);
  return mask ? dispatch_window<__half, true>(p, d, s)
              : dispatch_window<__half, false>(p, d, s);
}
