// Space-to-depth relayout with a fused cast, for Hopper (sm_90a).
//
// Replaces the TPU kernel dctseg/ops/pallas/relayout.py space_to_depth
// (_s2d_kernel): a contiguous (N, D, H, W, C) input becomes the contiguous
// (N, D/2, H/2, W/2, 8C) s2d view, output channel ((iz*2 + iy)*2 + ix)*C + c
// reading input (n, 2z + iz, 2y + iy, 2x + ix, c), cast to the output dtype
// on the way (round to nearest even, as PyTorch's cast).  A pure relayout:
// bit-identical to space_to_depth(x.to(out_dtype)) in plain PyTorch.
//
// Bound on the H100: bytes.  The function reads the input once and writes
// the output once and does no arithmetic.  The structure the design uses:
// for one output row (n, z, y, x) the channels ix*C + c, ix in {0, 1}, of one
// (iz, iy) pair are a contiguous 2C-element run of input row
// (n, 2z + iz, 2y + iy, 2x), so an output row is four such runs side by side.
// One thread moves V consecutive output elements (16 bytes where the widths
// allow) with one vector store, and reads the V matching input elements of
// one run with vector loads: 32-byte runs for C = 4 f32, 128-byte runs for
// C = 32 bf16.  Neighbouring threads cover neighbouring output vectors, so a
// warp stores one contiguous stretch and reads four.  V is the largest of
// 8, 4, 2, 1 that divides 2C and fits 16 bytes of output and whose vectors
// are aligned; widths where C*size is not a multiple of 16 take the narrower
// (down to scalar) instantiations.  No shared memory, no reuse: each byte
// moves once.

#include <type_traits>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kThreads = 256;

template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads)
s2d_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
           unsigned int vectors, int D2, int H2, int W2, int C) {
  const int two_c = 2 * C;
  const int vec_per_row = 8 * C / V;
  for (unsigned int v = blockIdx.x * kThreads + threadIdx.x; v < vectors;
       v += gridDim.x * kThreads) {
    unsigned int r = v / vec_per_row;                // output row
    const int ch = (int)(v - r * vec_per_row) * V;    // first output channel
    const int q = ch / two_c;                        // iz * 2 + iy
    const int within = ch - q * two_c;               // ix * C + c
    const int iz = q >> 1, iy = q & 1;
    const unsigned int xo = r % W2;
    r /= W2;
    const unsigned int yo = r % H2;
    r /= H2;
    const unsigned int zo = r % D2;
    const unsigned int n = r / D2;
    const long in_row =
        ((((long)n * 2 * D2 + 2 * zo + iz) * 2 * H2 + 2 * yo + iy) * 2 * W2
         + 2 * xo);
    const Tin* src = x + in_row * C + within;
    const Pack<Tin, V> p = *reinterpret_cast<const Pack<Tin, V>*>(src);
    Pack<Tout, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (std::is_same<Tin, Tout>::value) {
        o.v[j] = p.v[j];
      } else {
        o.v[j] = from_f32<Tout>(to_f32(p.v[j]));
      }
    }
    *reinterpret_cast<Pack<Tout, V>*>(out + (long)v * V) = o;
  }
}

template <typename Tin, typename Tout, int V>
cudaError_t launch(const void* x, void* out, int n, int d, int h, int w,
                   int c, cudaStream_t stream) {
  const long vectors = (long)n * d * h * w * c / V;
  const long want = (vectors + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132L * 32 ? want : 132L * 32);
  s2d_kernel<Tin, Tout, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out),
      (unsigned int)vectors, d / 2, h / 2, w / 2, c);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t dispatch_vec(const void* x, void* out, int n, int d, int h,
                         int w, int c, int vec, cudaStream_t stream) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(Tout) <= 2)
        return launch<Tin, Tout, 8>(x, out, n, d, h, w, c, stream);
      return cudaErrorInvalidValue;
    case 4: return launch<Tin, Tout, 4>(x, out, n, d, h, w, c, stream);
    case 2: return launch<Tin, Tout, 2>(x, out, n, d, h, w, c, stream);
    case 1: return launch<Tin, Tout, 1>(x, out, n, d, h, w, c, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tin>
cudaError_t dispatch_out(const void* x, void* out, int n, int d, int h,
                         int w, int c, int out_dtype, int vec,
                         cudaStream_t stream) {
  switch (out_dtype) {
    case kF32:
      return dispatch_vec<Tin, float>(x, out, n, d, h, w, c, vec, stream);
    case kBF16:
      return dispatch_vec<Tin, __nv_bfloat16>(x, out, n, d, h, w, c, vec,
                                              stream);
    case kF16:
      return dispatch_vec<Tin, __half>(x, out, n, d, h, w, c, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// x: contiguous (n, d, h, w, c) of in_dtype; out: contiguous
// (n, d/2, h/2, w/2, 8c) of out_dtype.  vec: output elements per thread, a
// divisor of 2c whose vectors the wrapper found aligned.
extern "C" int dctseg_space_to_depth(const void* x, void* out, int n, int d,
                                     int h, int w, int c, int in_dtype,
                                     int out_dtype, int vec, void* stream) {
  if (n < 1 || c < 1 || d < 2 || h < 2 || w < 2 || (d | h | w) & 1)
    return cudaErrorInvalidValue;
  if ((2 * c) % vec) return cudaErrorInvalidValue;
  if ((long)n * d * h * w * c / vec > 0x7fffffffL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32:
      return dispatch_out<float>(x, out, n, d, h, w, c, out_dtype, vec, st);
    case kBF16:
      return dispatch_out<__nv_bfloat16>(x, out, n, d, h, w, c, out_dtype,
                                         vec, st);
    case kF16:
      return dispatch_out<__half>(x, out, n, d, h, w, c, out_dtype, vec, st);
    default: return cudaErrorInvalidValue;
  }
}
