// K9: LayerNorm over the channels of token rows, forward, for Hopper
// (sm_90a), with the Swin block's padding, cyclic shift and window
// partition in its own addressing.
//
// Replaces no TPU kernel: the JAX package has no Swin model.  It replaces
// the torch sequence of models/swin_unetr.py's encoder (MONAI's
// SwinTransformerBlock, PatchMerging and proj_out): F.layer_norm on an f32
// copy of the bf16 activations, the casts up and down, F.pad, torch.roll,
// the window partition and its reverse, and the attention's residual add.
// Each of those passes reads and writes every token row; K9 reads each
// input row once and writes each output row once.
//
// What it computes, per token row of C channels: mean and centred variance
// in f32, y = (x - mean) * rsqrt(var + eps) * w + b in f32 (w, b: f32, or
// none), rounded once to the working dtype (bf16, f16 or f32).  Three
// routes (ops/layernorm.py):
//   0 to_windows       -- norm1 of a Swin block.  Output row o of the
//      (B * nW, N, C) windows over the padded grid (Dp, Hp, Wp) is token p
//      (window origin + in-window offset) of the grid rolled by -s, so it
//      reads x at q = (p + s) mod Dp on each axis; where q falls in the
//      padding it writes a row of zeros (MONAI pads after the norm).
//   1 windows_residual -- after the attention's output projection.  For
//      token q of the unpadded grid it reads the window row at
//      p = (q - s) mod Dp, adds x[q] in f32 and rounds once (x + y in the
//      working dtype), writes that sum x', then norm2 of the rounded x'.
//   2 plain            -- rows in place (PatchMerging's norm, proj_out).
//
// Bound on the H100: bytes, at a few flops a byte.  What the design does:
//   * A group of G lanes owns a row (G = the largest power of two up to 32
//     dividing the row's 16-byte vectors: 2 lanes at C = 48 in bf16, a warp
//     from C = 768); each lane keeps V vectors of the row in registers,
//     vector i * G + g, so the group's loads and stores cover whole 32-byte
//     sectors.  The statistics come from registers with xor shuffles inside
//     the group: the row is read once, and nothing is staged.
//   * One block of 256 threads for 256 / G consecutive output rows.  The
//     stores go to the contiguous side: window order on route 0, the grid
//     on route 1.  The gathered side's rows are whole 16-byte vectors
//     wherever they lie.
//   * Index arithmetic per row (a few integer divisions by the grid and
//     window) costs nothing beside the row's bytes.
//   * No workspace, no atomics, one launch a call: two calls give the same
//     bits, and a CUDA graph may capture it.
#include <cstdint>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;
// channels a lane keeps in registers, at most
constexpr int kMaxPerLane = 96;

enum Route : int { kToWindows = 0, kWindowsResidual = 1, kPlain = 2 };

struct LnParams {
  const void* x;       // (B, D, H, W, C), or rows of C on the plain route
  const void* win;     // route 1: the (B * nW, N, C) windows
  void* out;           // route 0: windows; route 1: x + y; route 2: rows
  void* out2;          // route 1: norm2(x + y)
  const float* w;      // (C) f32, or null
  const float* b;      // (C) f32, or null
  long rows;           // output rows
  int c, lanes, route;
  int d, h, w_;        // the unpadded grid
  int dp, hp, wp;      // the padded grid
  int wd, wh, ww;      // the window
  int sd, sh, sw;      // the shift
  float eps;
};

// Row of the unpadded grid that output row `o` of the windows reads (route
// 0), or -1 where it is padding.
__device__ __forceinline__ long window_source(const LnParams& p, long o) {
  const int n = p.wd * p.wh * p.ww;
  const int nwh = p.hp / p.wh, nww = p.wp / p.ww;
  const int nw = (p.dp / p.wd) * nwh * nww;
  const int t = (int)(o % n);
  const long win = o / n;
  const int b = (int)(win / nw), wi = (int)(win % nw);
  const int iw = wi % nww, ih = (wi / nww) % nwh, id = wi / (nww * nwh);
  const int tw = t % p.ww, th = (t / p.ww) % p.wh, td = t / (p.ww * p.wh);
  int qd = id * p.wd + td + p.sd, qh = ih * p.wh + th + p.sh,
      qw = iw * p.ww + tw + p.sw;
  if (qd >= p.dp) qd -= p.dp;
  if (qh >= p.hp) qh -= p.hp;
  if (qw >= p.wp) qw -= p.wp;
  if (qd >= p.d || qh >= p.h || qw >= p.w_) return -1;
  return (((long)b * p.d + qd) * p.h + qh) * p.w_ + qw;
}

// Window row that token `q` of the unpadded grid reads (route 1).
__device__ __forceinline__ long window_row(const LnParams& p, long q) {
  const int qw = (int)(q % p.w_), qh = (int)((q / p.w_) % p.h);
  const long bd = q / ((long)p.w_ * p.h);
  const int qd = (int)(bd % p.d), b = (int)(bd / p.d);
  int pd = qd - p.sd, ph = qh - p.sh, pw = qw - p.sw;
  if (pd < 0) pd += p.dp;
  if (ph < 0) ph += p.hp;
  if (pw < 0) pw += p.wp;
  const int nwh = p.hp / p.wh, nww = p.wp / p.ww;
  const int nw = (p.dp / p.wd) * nwh * nww;
  const int win = ((pd / p.wd) * nwh + ph / p.wh) * nww + pw / p.ww;
  const int t = ((pd % p.wd) * p.wh + ph % p.wh) * p.ww + pw % p.ww;
  return ((long)b * nw + win) * (p.wd * p.wh * p.ww) + t;
}

// Sum over the G lanes of a row's group (G a power of two, groups aligned
// in the warp; every lane of the warp takes part).
__device__ __forceinline__ float group_sum(float s, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const LnParams p) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31, g = lane & (p.lanes - 1);
  const long row = ((long)blockIdx.x * kThreads + threadIdx.x) / p.lanes;
  const bool live = row < p.rows;
  long src = row;
  if (p.route == kToWindows && live) src = window_source(p, row);
  const bool read = live && src >= 0;

  float v[V * VEC];
  if (read) {
    const P* x = reinterpret_cast<const P*>(p.x) + src * (p.c / VEC);
    P in[V];
#pragma unroll
    for (int i = 0; i < V; ++i) in[i] = x[i * p.lanes + g];
    if (p.route == kWindowsResidual) {
      const P* y = reinterpret_cast<const P*>(p.win) +
                   window_row(p, row) * (p.c / VEC);
      P* sum = reinterpret_cast<P*>(p.out) + row * (p.c / VEC);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const P a = y[i * p.lanes + g];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          in[i].v[j] = from_f32<T>(to_f32(in[i].v[j]) + to_f32(a.v[j]));
        sum[i * p.lanes + g] = in[i];
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i * VEC + j] = to_f32(in[i].v[j]);
  } else {
#pragma unroll
    for (int k = 0; k < V * VEC; ++k) v[k] = 0.f;
  }

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V * VEC; ++k) s += v[k];
  const float mean = group_sum(s, p.lanes) / p.c;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < V * VEC; ++k) {
    const float e = v[k] - mean;
    q += e * e;
  }
  const float rstd = rsqrtf(group_sum(q, p.lanes) / p.c + p.eps);
  if (!live) return;

  P* out = reinterpret_cast<P*>(p.route == kWindowsResidual ? p.out2 : p.out) +
           row * (p.c / VEC);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    // this vector's channels of w and b, 16 bytes at a time (the whole
    // warp reads the same few sectors: L1 broadcasts them)
    const int c4 = (i * p.lanes + g) * (VEC / 4);
    float w[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      const float4 wk = p.w ? __ldg(reinterpret_cast<const float4*>(p.w) +
                                    c4 + k)
                            : make_float4(1.f, 1.f, 1.f, 1.f);
      const float4 bk = p.b ? __ldg(reinterpret_cast<const float4*>(p.b) +
                                    c4 + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      w[4 * k] = wk.x;
      w[4 * k + 1] = wk.y;
      w[4 * k + 2] = wk.z;
      w[4 * k + 3] = wk.w;
      b[4 * k] = bk.x;
      b[4 * k + 1] = bk.y;
      b[4 * k + 2] = bk.z;
      b[4 * k + 3] = bk.w;
    }
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f32<T>(read ? (v[i * VEC + j] - mean) * rstd * w[j] + b[j]
                                : 0.f);
    out[i * p.lanes + g] = o;
  }
}

// The kernel of V vectors a lane, or null above kMaxPerLane channels a
// lane (ops/layernorm.py plan_lanes never asks for one).
template <typename T, int V>
const void* kernel_of() {
  if constexpr (V * (16 / sizeof(T)) <= kMaxPerLane)
    return (const void*)layer_norm_kernel<T, V>;
  else
    return nullptr;
}

template <typename T>
const void* pick_v(int v) {
  switch (v) {
    case 1: return kernel_of<T, 1>();
    case 2: return kernel_of<T, 2>();
    case 3: return kernel_of<T, 3>();
    case 4: return kernel_of<T, 4>();
    case 6: return kernel_of<T, 6>();
    case 8: return kernel_of<T, 8>();
    case 12: return kernel_of<T, 12>();
    case 16: return kernel_of<T, 16>();
    case 24: return kernel_of<T, 24>();
    default: return nullptr;
  }
}

const void* pick(int dtype, int v) {
  switch (dtype) {
    case kF32: return pick_v<float>(v);
    case kBF16: return pick_v<__nv_bfloat16>(v);
    case kF16: return pick_v<__half>(v);
    default: return nullptr;
  }
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// args (int64): x, windows, out, out2, weight, bias, rows, c, route, d, h,
// w, dp, hp, wp, wd, wh, ww, sd, sh, sw, dtype, vectors a lane (V), lanes.
extern "C" int dctseg_layer_norm(const int64_t* a, float eps, void* stream) {
  LnParams p;
  p.x = reinterpret_cast<const void*>(a[0]);
  p.win = reinterpret_cast<const void*>(a[1]);
  p.out = reinterpret_cast<void*>(a[2]);
  p.out2 = reinterpret_cast<void*>(a[3]);
  p.w = reinterpret_cast<const float*>(a[4]);
  p.b = reinterpret_cast<const float*>(a[5]);
  p.rows = a[6];
  p.c = (int)a[7];
  p.route = (int)a[8];
  p.d = (int)a[9];
  p.h = (int)a[10];
  p.w_ = (int)a[11];
  p.dp = (int)a[12];
  p.hp = (int)a[13];
  p.wp = (int)a[14];
  p.wd = (int)a[15];
  p.wh = (int)a[16];
  p.ww = (int)a[17];
  p.sd = (int)a[18];
  p.sh = (int)a[19];
  p.sw = (int)a[20];
  const int dtype = (int)a[21], v = (int)a[22];
  p.lanes = (int)a[23];
  p.eps = eps;
  const int elem = dtype == kF32 ? 4 : 2;
  const int vec = 16 / elem;
  const bool grid_ok =
      p.route == kPlain ||
      (p.wd >= 1 && p.wh >= 1 && p.ww >= 1 && p.dp % p.wd == 0 &&
       p.hp % p.wh == 0 && p.wp % p.ww == 0 && p.d >= 1 && p.h >= 1 &&
       p.w_ >= 1 && p.d <= p.dp && p.h <= p.hp && p.w_ <= p.wp &&
       p.sd >= 0 && p.sh >= 0 && p.sw >= 0 && p.sd < p.wd && p.sh < p.wh &&
       p.sw < p.ww);
  const bool ok =
      p.rows >= 1 && p.route >= kToWindows && p.route <= kPlain && grid_ok &&
      p.lanes >= 1 && p.lanes <= 32 && (p.lanes & (p.lanes - 1)) == 0 &&
      p.c == v * p.lanes * vec && aligned(p.x) && aligned(p.out) &&
      (p.route != kWindowsResidual || (aligned(p.win) && aligned(p.out2))) &&
      (!p.w || aligned(p.w)) && (!p.b || aligned(p.b)) &&
      p.rows * p.lanes / kThreads < (1L << 31);
  if (!ok) return cudaErrorInvalidValue;
  const void* k = pick(dtype, v);
  if (!k) return cudaErrorInvalidValue;
  const long blocks = (p.rows * p.lanes + kThreads - 1) / kThreads;
  void* args[] = {&p};
  return cudaLaunchKernel(k, dim3((unsigned)blocks), dim3(kThreads), args, 0,
                          static_cast<cudaStream_t>(stream));
}
