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
// the output once and does no arithmetic.  The structure the kernel uses:
// output row (n, z, y) -- W/2 pixels of 8C channels, contiguous -- is the
// four input rows (n, 2z + iz, 2y + iy, :, :), each W*C elements long and
// contiguous, interleaved in 2C-element runs: pixel x's channels
// (iz*2 + iy)*2C + (ix*C + c) are run x of input row (iz, iy).
//
// A grid-stride loop in which one thread moves V consecutive output
// elements (16 bytes where the widths allow) with one vector store, reading
// the V matching input elements of one run with one vector load; V is the
// largest of 8, 4, 2, 1 that divides 2C, fits 16 bytes of output and finds
// both pointers aligned.  Neighbouring threads cover neighbouring output
// vectors, so a warp stores one contiguous stretch and reads four.  The
// wrapper's launch plan (ops/relayout.py plan_relayout) gives one thread a
// vector up to 64 blocks per SM: enough independent loads in flight to
// stream from HBM.

#include <cstdint>
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
    unsigned int r = v / vec_per_row;                // output pixel
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
    const Pack<Tin, V> p =
        *reinterpret_cast<const Pack<Tin, V>*>(x + in_row * C + within);
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

template <typename Tin, typename Tout>
const void* pick_vec(int vec) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(Tout) <= 2)
        return reinterpret_cast<const void*>(&s2d_kernel<Tin, Tout, 8>);
      return nullptr;
    case 4: return reinterpret_cast<const void*>(&s2d_kernel<Tin, Tout, 4>);
    case 2: return reinterpret_cast<const void*>(&s2d_kernel<Tin, Tout, 2>);
    case 1: return reinterpret_cast<const void*>(&s2d_kernel<Tin, Tout, 1>);
    default: return nullptr;
  }
}

template <typename Tin>
const void* pick_out(int out_dtype, int vec) {
  switch (out_dtype) {
    case kF32: return pick_vec<Tin, float>(vec);
    case kBF16: return pick_vec<Tin, __nv_bfloat16>(vec);
    case kF16: return pick_vec<Tin, __half>(vec);
    default: return nullptr;
  }
}

const void* pick(int in_dtype, int out_dtype, int vec) {
  switch (in_dtype) {
    case kF32: return pick_out<float>(out_dtype, vec);
    case kBF16: return pick_out<__nv_bfloat16>(out_dtype, vec);
    case kF16: return pick_out<__half>(out_dtype, vec);
    default: return nullptr;
  }
}

int itemsize(int dtype) { return dtype == kF32 ? 4 : 2; }

}  // namespace
}  // namespace dctseg

using namespace dctseg;

// args (int64, ops/relayout.py _launch): x, out, n, d, h, w, c, in_dtype,
// out_dtype, vec, grid.  x: contiguous (n, d, h, w, c); out: contiguous
// (n, d/2, h/2, w/2, 8c).  The plan's vector width is checked against the
// shape and the pointers here; a launch that does not fit them is refused.
extern "C" int dctseg_space_to_depth(const int64_t* a, void* stream) {
  const long long n = a[2], d = a[3], h = a[4], w = a[5], c = a[6];
  const int in_dtype = (int)a[7], out_dtype = (int)a[8];
  const int vec = (int)a[9], grid = (int)a[10];
  const void* k = pick(in_dtype, out_dtype, vec);
  if (!k || n < 1 || c < 1 || d < 2 || h < 2 || w < 2 || (d | h | w) & 1 ||
      grid < 1 || n * d * h * w * c > 0x7fffffffLL || (2 * c) % vec ||
      a[0] % (vec * itemsize(in_dtype)) || a[1] % (vec * itemsize(out_dtype)))
    return cudaErrorInvalidValue;
  const void* x = reinterpret_cast<const void*>(a[0]);
  void* out = reinterpret_cast<void*>(a[1]);
  unsigned int vectors = (unsigned int)(n * d * h * w * c / vec);
  int d2 = (int)d / 2, h2 = (int)h / 2, w2 = (int)w / 2, ci = (int)c;
  void* args[] = {&x, &out, &vectors, &d2, &h2, &w2, &ci};
  // No host state changes per call (the pointers aside): a CUDA graph may
  // capture this launch and replay it.
  return cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, 0,
                          static_cast<cudaStream_t>(stream));
}
