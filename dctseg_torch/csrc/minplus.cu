// One min-plus pass of the exact squared Euclidean distance transform, for
// Hopper (sm_90a), as a lower-envelope transform.
//
// Replaces the TPU kernel dctseg/ops/pallas/minplus.py minplus_sublane
// (_minplus_kernel): along one axis of length D <= 256,
//     out[i] = min_j x[j] + (i - j)^2,
// the one-axis pass that squared_edt_3d runs three times.  Two layouts:
// the pass along axis 1 of a contiguous (A, D, B) array (dctseg_minplus_pass)
// and along the minor axis of a contiguous (R, D) array
// (dctseg_minplus_pass_minor), so that the three passes of a volume run on
// views of it, with no transposed copy.
//
// Algorithm: the lower envelope of the parabolas x[j] + (i - j)^2
// (Felzenszwalb & Huttenlocher), O(D) per column where the brute force
// does D^2 add-and-min pairs.  One forward scan over j builds the envelope,
// one scan fills the output.
//
// Exactness: the inputs are integers in [0, 2^24 - (D - 1)^2] held in f32
// (the EDT's 1e7 sentinel plus at most 3 * 255^2, dctseg_torch/ops/edt.py),
// so the scan runs in integers.  With c(j) = x[j] + j^2, parabola q is no
// higher than parabola v < q at position i iff c(q) - c(v) <= 2 i (q - v),
// so two parabolas cross at N / (2 d), N = c(q) - c(v), d = q - v.  The
// envelope keeps each parabola's lower boundary as that fraction (0 for
// the bottom one); q pops the top while q's crossing with it lies at or
// before the top's boundary, N_q d_top <= N_top d_q: an exact int64
// product, so the scan makes no division and rounds nothing.  q is not
// pushed where it wins nowhere in [0, D - 1] (N > 2 (D - 1) d).  The fill
// walks the positions from the last one down and steps to the entry below
// while that one is strictly lower there; a tie keeps either parabola,
// both give the same value.  x[v] + (i - v)^2 is an integer below 2^24,
// exact in f32, so the result is bit-identical to the brute force
// (minplus_pass_plain).  Do not build this file with --use_fast_math.
//
// Bound on the H100: bytes in the count of the chip check (each pass reads
// and writes the volume once), latency in fact: each column is a serial
// scan.  Design: one column per thread, 32 columns per one-warp block.
// The column is staged in shared memory by 4-byte cp.async copies, all in
// flight at once (coalesced: lanes on consecutive b, or, in the minor mode,
// a row's consecutive elements written transposed), then turned into
// int32 in place.  The envelope lives in place of the values already
// consumed: entry k, written while scanning j >= k, packs its vertex (8
// bits, D <= 256) over its value (24 bits), so shared memory holds 4 bytes
// per element (30 KB per block at D = 240, 7 blocks per SM) and the
// scan's dependent chain is a few integer operations per element, with the
// next value and the next entry below read ahead.  The scan is one flat
// loop of pops and pushes, so that the lanes of a warp wait on each
// other's pops only at the end.  A constant column (all sentinel, as most
// of an EDT volume is) is its own output and skips the scan.  The fill
// writes the output straight out: coalesced along b, or, in the minor
// mode, through a 32 x 33 tile per 32 positions.  Slots are [i][lane] with
// a row pitch of 32 words (conflict-free at any divergent i) or 33 in the
// minor mode (conflict-free transposed staging).

#include <stdint.h>

#include "common.cuh"

namespace dctseg {
namespace {

constexpr int kMaxD = 256;
constexpr int kCols = 32;                   // columns per block, one per lane

// 4-byte asynchronous copy: the staging issues a whole column's loads
// before it waits for any, instead of one HBM latency per element
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// a staged value (f32 bits of an integer below 2^24) as int
__device__ __forceinline__ int as_int(uint32_t bits) {
  return (int)__uint_as_float(bits);
}

// Minor mode: pitch 33, x is (R, D) and block c takes rows 32c .. 32c + 31.
// Otherwise: pitch 32, x is (A, D, B) and block c takes a = c / tiles and
// columns b = 32 (c % tiles) + lane.
template <bool kMinor>
__global__ void __launch_bounds__(kCols)
envelope_kernel(const float* __restrict__ x, float* __restrict__ out, int D,
                long B, long tiles, long rows) {
  constexpr int P = kMinor ? kCols + 1 : kCols;
  extern __shared__ uint32_t slots[];       // [D][P] values, then envelope
  float* tile = reinterpret_cast<float*>(slots + D * P);   // minor: [32][33]
  const int lane = threadIdx.x;

  long base, b = 0;
  int nrows = kCols;
  bool valid = true;
  if (kMinor) {
    base = (long)blockIdx.x * kCols * D;
    nrows = (int)min((long)kCols, rows - (long)blockIdx.x * kCols);
    for (int r = 0; r < nrows; ++r)
      for (int i = lane; i < D; i += kCols)
        cp_async4(slots + i * P + r, x + base + (long)r * D + i);
    for (int r = nrows; r < kCols; ++r)
      for (int i = lane; i < D; i += kCols) slots[i * P + r] = 0u;
  } else {
    const long a = blockIdx.x / tiles;
    b = (blockIdx.x - a * tiles) * kCols + lane;
    valid = b < B;
    base = a * D * B + b;
    for (int i = 0; i < D; ++i) {
      if (valid)
        cp_async4(slots + i * P + lane, x + base + (long)i * B);
      else
        slots[i * P + lane] = 0u;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // The envelope, as a stack over slots 0 .. n-1: entry k packs its vertex
  // over its value.  In registers: the top (vertex tv, c = x + v^2, lower
  // boundary tn / (2 td)) and the entry below it (sv, sc).
  uint32_t* col = slots + lane;
  // the staged f32 values as int32, in place: the scan then reads them
  // with no conversion on its dependent chain.  A constant column is its
  // own output (x[j] + (i - j)^2 is least at j = i): it skips the scan.
  const int x0 = as_int(col[0]);
  int diff = 0;
  for (int i = 0; i < D; ++i) {
    const int xi = as_int(col[i * P]);
    col[i * P] = (uint32_t)xi;
    diff |= xi ^ x0;
  }
  const bool uniform = diff == 0;
  int tv = 0, tc = x0, tn = 0, td = 1, sv = 0, sc = 0;
  int n = 1;                                // entry 0 (vertex 0) is in place
  // One flat loop: each turn either pops the top or takes position q, so
  // a lane that pops a long run (a zero after a run of sentinels pops
  // them all) holds the warp up by its own pops only, not by the sum of
  // every lane's pops at each q.
  int q = uniform ? D : 1;
  int fq = D > 1 ? (int)col[P] : 0;
  while (q < D) {
    // position q + 1, read ahead: pushes write slots <= q only
    const int fnext = q + 1 < D ? (int)col[(q + 1) * P] : 0;
    const int cq = fq + q * q;
    // pop while q is no higher than the top from the top's lower boundary
    // on: x(q, top) <= tn / (2 td), crossed out
    if (n > 0 && (long long)(cq - tc) * td <= (long long)tn * (q - tv)) {
      if (--n > 0) {
        tv = sv;
        tc = sc;
        if (n >= 2) {
          const uint32_t e = col[(n - 2) * P];
          sv = (int)(e >> 24);
          sc = (int)(e & 0xFFFFFFu) + sv * sv;
          tn = tc - sc;
          td = tv - sv;
        } else {
          tn = 0;                           // the bottom: boundary 0
          td = 1;
        }
      }
      continue;
    }
    const int num = cq - tc, den = q - tv;
    bool push = true;
    if (n == 0) {                           // q is lowest on all of [0, D)
      tn = 0;
      td = 1;
    } else if (num > 2 * den * (D - 1)) {   // q wins nowhere in [0, D)
      push = false;
    } else {
      tn = num;
      td = den;
      sv = tv;
      sc = tc;
    }
    if (push) {                             // slot n <= q: consumed
      col[n * P] = ((uint32_t)q << 24) | (uint32_t)fq;
      ++n;
      tv = q;
      tc = cq;
    }
    ++q;
    fq = fnext;
  }

  // fill from the end: step down while the entry below is strictly lower.
  // Entries k (v, fv) and k - 1 (lv, lf) in registers, entry k - 2 read
  // ahead (e2), so a step needs no shared-memory read on its chain.
  int k = n - 1;
  int v = tv, fv = tc - tv * tv, lv = sv, lf = sc - sv * sv;
  uint32_t e2 = k >= 2 ? col[(k - 2) * P] : 0u;
  for (int i = D - 1; i >= 0; --i) {
    while (k > 0 && lf + (i - lv) * (i - lv) < fv + (i - v) * (i - v)) {
      v = lv;
      fv = lf;
      --k;
      lv = (int)(e2 >> 24);
      lf = (int)(e2 & 0xFFFFFFu);
      e2 = k >= 2 ? col[(k - 2) * P] : 0u;
    }
    const float y = (float)(uniform ? x0 : fv + (i - v) * (i - v));
    if (kMinor) {
      // through a 32 x 33 tile, so that 32 positions of each row go out
      // as one coalesced run
      tile[(i & 31) * (kCols + 1) + lane] = y;
      if ((i & 31) == 0) {
        __syncwarp();
        const int len = min(kCols, D - i);
        for (int r = 0; r < nrows; ++r)
          if (lane < len)
            out[base + (long)r * D + i + lane] = tile[lane * (kCols + 1) + r];
        __syncwarp();
      }
    } else if (valid) {
      out[base + (long)i * B] = y;
    }
  }
}

template <bool kMinor>
cudaError_t launch(const void* x, void* out, long blocks, int d, long b,
                   long tiles, long rows, cudaStream_t stream) {
  const int pitch = kMinor ? kCols + 1 : kCols;
  const size_t smem =
      ((size_t)d * pitch + (kMinor ? kCols * (kCols + 1) : 0)) * 4;
  envelope_kernel<kMinor><<<(unsigned)blocks, kCols, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), d, b, tiles,
      rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dctseg

using namespace dctseg;

extern "C" int dctseg_minplus_pass(const void* x, void* out, long a, int d,
                                   long b, void* stream) {
  if (a < 1 || b < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  const long tiles = (b + kCols - 1) / kCols;
  if (a * tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  return launch<false>(x, out, a * tiles, d, b, tiles, 0,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int dctseg_minplus_pass_minor(const void* x, void* out, long rows,
                                         int d, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  const long blocks = (rows + kCols - 1) / kCols;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  return launch<true>(x, out, blocks, d, 1, 1, rows,
                      static_cast<cudaStream_t>(stream));
}
