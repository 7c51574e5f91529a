// Kernels 1 and 4: the quantised GMM CDF tables (shared device code).
//
// Kernel 1 replaces llicti_tpu/ops/cdf_pallas.py:gmm_cdf_from_pmap_pallas
// (kernel body _cdf_pmap_kernel).  Per pixel it slices std, mean and weight
// out of the channel-minor pmap row, bounds them, applies the cross-colour
// mean updates, sums the M-mixture CDF (normal or logistic) at P sampling
// points, quantises to the coder's 16-bit contract and emits the encoder's
// (start, freq) at the pixel's true symbol.
//
// Kernel 4 replaces llicti_tpu/ops/cdf_pallas.py:gmm_cdf_table_int32_pallas
// (kernel body _cdf_kernel): normal mixtures only, parameters given as
// [n, X] arrays, (pt - mean) / std divided (Kernel 1 multiplies by 1/std),
// no mean updates and no (start, freq).
//
// What bounds them on the H100: issue, not bytes.  Each table entry costs
// M mixture terms of ~40 instructions (the A&S erf's reciprocal, polynomial
// and expf, with no fused multiply-add) against 4 bytes written.
// Design:
//  * kLanes lanes per pixel walk the row in chunks of kLanes consecutive
//    entries; the running max along P is a shuffle scan inside the lane
//    group plus a carry between chunks; stores are contiguous per group.
//    With 8 lanes a row of P = 97, 161 or 257 leaves 7 lanes idle in its
//    last chunk, against 31 with a whole warp, and none at P = 256.
//  * The kernels are templates on the mixture count, so the per-pixel
//    parameters live in registers (no stack frame).
//  * A normal mixture term whose value is fixed skips the arithmetic: for
//    |z / sqrt 2| > 10.5 expf(-x^2) is 0 in float and the term is exactly w
//    or 0.  Every float input of the shortcut is held against the full
//    formula on the card (llicti_cdf_check_saturation).  Neighbouring
//    points share their saturation, so the branch rarely diverges inside a
//    lane group.  The logistic branch has no such shortcut: its terms
//    almost never saturate (z <= 25 at its scale bound 0.04), and the test
//    cost more than it saved (PERF.md).
//
// Numerics follow the Pallas kernels operation for operation (A&S 7.1.26
// erf, not erff; the sigmoid as 1 / (1 + exp(-z)), the expression
// jax.nn.sigmoid lowers to; round half to even; the same sums in the same
// order).  The __f*_rn intrinsics keep nvcc from contracting a multiply and
// an add into one FMA, which would round differently; __frcp_rn(d) is the
// correctly rounded 1 / d, the same bits as __fdiv_rn(1.f, d).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace llicti {

// 8 lanes a pixel and 8 warps a block were the fastest of the shapes
// timed (8, 16 or 32 lanes; 4, 8 or 16 warps; PERF.md)
constexpr int kLanes = 8;  // lanes per pixel, a power of two <= 32
constexpr int kThreads = 256;
constexpr int kPixelsPerBlock = kThreads / kLanes;
constexpr int kMaxMixtures = 16;
constexpr float kScaleBoundNormal = (float)(0.11 / 255.0);
constexpr float kWeightBound = 1e-6f;
constexpr float kSqrt2Inv = 0.7071067811865476f;
constexpr float kErfSaturated = 10.5f;  // |x| above: erf_as(x) == sign(x)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __frcp_rn(__fadd_rn(1.f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  const float poly = __fmul_rn(t, p);
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))));
}

// Phi(z) from x = z / sqrt 2
__device__ __forceinline__ float phi_x(float x) {
  return __fmul_rn(0.5f, __fadd_rn(1.f, erf_as(x)));
}

__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(__fadd_rn(1.f, expf(-z)));
}

// w * Phi(z), the normal mixture term
__device__ __forceinline__ float normal_term(float z, float w) {
  const float x = __fmul_rn(z, kSqrt2Inv);
  if (fabsf(x) > kErfSaturated) return x > 0.f ? w : 0.f;
  return __fmul_rn(w, phi_x(x));
}

// w * sigmoid(z), the logistic mixture term
__device__ __forceinline__ float logistic_term(float z, float w) {
  return __fmul_rn(w, sigmoid(z));
}

// Normalised weights w[x] / (1e-9 + sum w), the sum taken left to right.
template <int M>
__device__ __forceinline__ void normalise(float (&w)[M]) {
  float wsum = 0.f;
#pragma unroll
  for (int x = 0; x < M; ++x) wsum = __fadd_rn(wsum, w[x]);
  const float den = __fadd_rn(1e-9f, wsum);
#pragma unroll
  for (int x = 0; x < M; ++x) w[x] = __fdiv_rn(w[x], den);
}

// One lane group writes one pixel's table row: cdf_at(pt) is the mixture
// CDF at a sampling point; the row is quantised to 2^16 - (P - 1), made
// monotone by a running max, lifted by the column index, and its last
// entry is 2^16.  ``out`` null: compute, store nothing.  Returns (in the
// group's lane 0) the entries at sym and sym + 1.
template <typename CdfAt>
__device__ __forceinline__ void write_row(const float* __restrict__ pts, int P,
                                          int gl, int* __restrict__ out,
                                          int sym, int& lo, int& hi,
                                          CdfAt cdf_at) {
  const float new_max = (float)(65536 - (P - 1));
  int carry = INT_MIN;
  lo = 0;
  hi = 0;
#pragma unroll 1  // a chunk already holds M independent mixture terms
  for (int base = 0; base < P; base += kLanes) {
    const int p = base + gl;
    int q = INT_MIN;
    if (p < P) {
      const float acc = cdf_at(pts[p]);
      q = (int)rintf(__fmul_rn(fminf(fmaxf(acc, 0.f), 1.f), new_max));
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {  // inclusive running max
      const int o = __shfl_up_sync(kFull, q, off, kLanes);
      if (gl >= off) q = max(q, o);
    }
    q = max(q, carry);
    carry = __shfl_sync(kFull, q, kLanes - 1, kLanes);
    if (p < P) {
      const int v = p == P - 1 ? 65536 : q + p;
      if (out) out[p] = v;
      if (p == sym) lo = v;
      if (p == sym + 1) hi = v;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {  // one lane holds each
    lo += __shfl_down_sync(kFull, lo, off, kLanes);
    hi += __shfl_down_sync(kFull, hi, off, kLanes);
  }
}

// Kernel 1's arguments (one struct, so the dispatch over M stays short).
struct PmapArgs {
  const float* pts;
  const float* pmap;
  const float* y;
  int* cum;
  int* start;
  int* freq;
  int n, P, CO, YC, std0, mean0, w0, n_upd, coef0, ych0, coef1, ych1,
      sym_ch, minv;
  float scale_bound;
};

// The first pixel of the warp of thread ``tid``: a warp leaves only when
// all its pixels are past n (its shuffles need every lane).
__device__ __forceinline__ long long warp_first_pixel(int tid) {
  return (long long)blockIdx.x * kPixelsPerBlock + (tid >> 5) * (32 / kLanes);
}

// Both kernels' launch bounds name a minimum of one block per SM: with the
// thread count alone, ptxas traded a 4-16 byte spill for occupancy at some
// mixture counts (M = 8, 13; X = 16).
#define LLICTI_CDF_BOUNDS __launch_bounds__(kThreads, 1)

template <bool kLogistic, int M>
__global__ void LLICTI_CDF_BOUNDS cdf_pmap_kernel(PmapArgs a) {
  const int gl = threadIdx.x % kLanes;
  if (warp_first_pixel(threadIdx.x) >= a.n) return;
  const long long pix =
      (long long)blockIdx.x * kPixelsPerBlock + threadIdx.x / kLanes;
  const bool active = pix < a.n;
  const long long pp = active ? pix : a.n - 1;  // computed, not stored
  const float* row = a.pmap + pp * a.CO;
  const float* yr = a.y + pp * a.YC;

  float mean[M], inv[M], w[M];
#pragma unroll
  for (int x = 0; x < M; ++x) w[x] = fmaxf(row[a.w0 + x], kWeightBound);
  normalise(w);
#pragma unroll
  for (int x = 0; x < M; ++x) {
    inv[x] = __frcp_rn(fmaxf(row[a.std0 + x], a.scale_bound));
    mean[x] = row[a.mean0 + x];
  }
  if (a.n_upd > 0) {
    const float y0 = yr[a.ych0];
#pragma unroll
    for (int x = 0; x < M; ++x)
      mean[x] = __fadd_rn(mean[x], __fmul_rn(row[a.coef0 + x], y0));
  }
  if (a.n_upd > 1) {
    const float y1 = yr[a.ych1];
#pragma unroll
    for (int x = 0; x < M; ++x)
      mean[x] = __fadd_rn(mean[x], __fmul_rn(row[a.coef1 + x], y1));
  }

  int sym = (int)rintf(__fmul_rn(yr[a.sym_ch], 255.f)) - a.minv;
  sym = min(max(sym, 0), a.P - 2);
  int lo, hi;
  write_row(a.pts, a.P, gl, active ? a.cum + pix * a.P : nullptr, sym, lo,
            hi, [&](float pt) {
              float acc = 0.f;
#pragma unroll
              for (int x = 0; x < M; ++x) {
                const float z = __fmul_rn(__fsub_rn(pt, mean[x]), inv[x]);
                acc = __fadd_rn(acc, kLogistic ? logistic_term(z, w[x])
                                               : normal_term(z, w[x]));
              }
              return acc;
            });
  if (active && gl == 0) {
    a.start[pix] = lo;
    a.freq[pix] = hi - lo;
  }
}

inline int blocks_for(int n) {
  return (n + kPixelsPerBlock - 1) / kPixelsPerBlock;
}

// Kernel 1 for one branch; M from 1 to kMaxMixtures.
template <bool kLogistic>
int launch_cdf_pmap(const PmapArgs& a, int M, cudaStream_t stream) {
  const dim3 grid(blocks_for(a.n)), block(kThreads);
  switch (M) {
#define LLICTI_CDF_CASE(m)                                              \
  case m:                                                               \
    cdf_pmap_kernel<kLogistic, m><<<grid, block, 0, stream>>>(a);       \
    break;
    LLICTI_CDF_CASE(1) LLICTI_CDF_CASE(2) LLICTI_CDF_CASE(3)
    LLICTI_CDF_CASE(4) LLICTI_CDF_CASE(5) LLICTI_CDF_CASE(6)
    LLICTI_CDF_CASE(7) LLICTI_CDF_CASE(8) LLICTI_CDF_CASE(9)
    LLICTI_CDF_CASE(10) LLICTI_CDF_CASE(11) LLICTI_CDF_CASE(12)
    LLICTI_CDF_CASE(13) LLICTI_CDF_CASE(14) LLICTI_CDF_CASE(15)
    LLICTI_CDF_CASE(16)
#undef LLICTI_CDF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of Kernel 1 at M mixtures (0 if M is out of range).
template <bool kLogistic>
int occupancy_cdf_pmap(int M) {
  int blocks = 0;
  switch (M) {
#define LLICTI_CDF_CASE(m)                                              \
  case m:                                                               \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                      \
        &blocks, cdf_pmap_kernel<kLogistic, m>, kThreads, 0);           \
    break;
    LLICTI_CDF_CASE(1) LLICTI_CDF_CASE(2) LLICTI_CDF_CASE(3)
    LLICTI_CDF_CASE(4) LLICTI_CDF_CASE(5) LLICTI_CDF_CASE(6)
    LLICTI_CDF_CASE(7) LLICTI_CDF_CASE(8) LLICTI_CDF_CASE(9)
    LLICTI_CDF_CASE(10) LLICTI_CDF_CASE(11) LLICTI_CDF_CASE(12)
    LLICTI_CDF_CASE(13) LLICTI_CDF_CASE(14) LLICTI_CDF_CASE(15)
    LLICTI_CDF_CASE(16)
#undef LLICTI_CDF_CASE
    default:
      break;
  }
  return blocks;
}

extern template int launch_cdf_pmap<true>(const PmapArgs&, int, cudaStream_t);
extern template int occupancy_cdf_pmap<true>(int);

}  // namespace llicti
