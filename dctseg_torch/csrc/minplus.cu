// One min-plus pass of the exact squared Euclidean distance transform, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/minplus.py minplus_sublane
// (_minplus_kernel): on a contiguous (A, D, B) float32 array
//     out[a, i, b] = min_j x[a, j, b] + (i - j)^2,
// the one-axis pass that squared_edt_3d runs three times.
//
// Exactness: every value is an integer below 2^24 (the 1e7 sentinel plus at
// most 3 * 255^2), so fmaf(i - j, i - j, x) and fminf are exact and the order
// of j does not matter: the result is bit-identical to the plain version.
// Do not build this file with --use_fast_math.
//
// Bound on the H100: operations.  A pass does A*D*D*B add-and-min pairs and
// moves 8*A*D*B bytes; at D = 240 that is 60 pairs per byte, far above what
// the card's f32 lanes do per byte of HBM.  Design: a block takes 32 columns
// (b) of one a over all D <= 256 rows and stages them once in shared memory
// (loads coalesced along b).  Warp g keeps the running minima of rows
// i = g, g + 8, g + 16, ... of its lane's column in registers; per j a lane
// reads one shared word (conflict-free: the lanes sit on consecutive
// columns) and does one fma and one fminf per row.  (i - j)^2 is formed in
// registers; no cost table.  The pass along the contiguous last axis (B = 1)
// runs on a transposed copy made by the wrapper, as the TPU kernel's caller
// does, so every pass sees a wide contiguous b.

#include <math.h>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kMaxD = 256;
constexpr int kTileB = 32;                  // columns per block, one per lane
constexpr int kGroups = 8;                  // warps per block
constexpr int kThreads = kTileB * kGroups;

// R: output rows per thread, R * kGroups >= D.
template <int R>
__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ x, float* __restrict__ out, int D,
               long B, long tiles) {
  __shared__ float tile[kMaxD * kTileB];
  const int lane = threadIdx.x % kTileB;
  const int g = threadIdx.x / kTileB;
  const long a = blockIdx.x / tiles;
  const long b = (blockIdx.x - a * tiles) * kTileB + lane;
  const bool valid = b < B;
  const float* xa = x + a * D * B;
  for (int j = g; j < D; j += kGroups)
    tile[j * kTileB + lane] = valid ? xa[(long)j * B + b] : 0.f;
  __syncthreads();

  float acc[R], di[R];                      // di[r] = i_r - j
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = INFINITY;
    di[r] = (float)(g + r * kGroups);
  }
  for (int j = 0; j < D; ++j) {
    const float v = tile[j * kTileB + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = fminf(acc[r], fmaf(di[r], di[r], v));
      di[r] -= 1.f;
    }
  }
  if (!valid) return;
  float* oa = out + a * D * B;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = g + r * kGroups;
    if (i < D) oa[(long)i * B + b] = acc[r];
  }
}

template <int R>
cudaError_t launch(const void* x, void* out, long a, int d, long b,
                   cudaStream_t stream) {
  const long tiles = (b + kTileB - 1) / kTileB;
  minplus_kernel<R><<<(unsigned)(a * tiles), kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), d, b, tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

extern "C" int dctseg_minplus_pass(const void* x, void* out, long a, int d,
                                   long b, void* stream) {
  if (a < 1 || b < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (a * ((b + kTileB - 1) / kTileB) > 0x7fffffffL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = (d + kGroups - 1) / kGroups;
  if (rows <= 8) return launch<8>(x, out, a, d, b, st);
  if (rows <= 16) return launch<16>(x, out, a, d, b, st);
  if (rows <= 24) return launch<24>(x, out, a, d, b, st);
  return launch<32>(x, out, a, d, b, st);
}
