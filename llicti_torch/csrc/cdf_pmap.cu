// Kernel 1: the quantised GMM CDF table, straight from the conv output.
// Kernel 4: the same table from pre-sliced std / mean / weight.
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
// What bounds them on the H100: both are write-bound, 0.5-2 KB of int32
// table per pixel (P = 257 or 513), against a few hundred bytes read.
// Design: one warp per pixel walks the row in chunks of 32 consecutive
// entries, so every table store is one coalesced 128-byte line; the running
// max along P is a warp shuffle scan plus a carry between chunks; the
// per-pixel parameters stay in registers.  No shared memory.
//
// Numerics follow the Pallas kernels operation for operation (A&S 7.1.26
// erf, not erff; the sigmoid as 1 / (1 + exp(-z)), the expression
// jax.nn.sigmoid lowers to; round half to even; the same sums in the same
// order).  The __f*_rn intrinsics keep nvcc from contracting a multiply and
// an add into one FMA, which would round differently.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxMixtures = 16;
constexpr float kScaleBoundNormal = (float)(0.11 / 255.0);
constexpr float kWeightBound = 1e-6f;
constexpr float kSqrt2Inv = 0.7071067811865476f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  const float poly = __fmul_rn(t, p);
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))));
}

__device__ __forceinline__ float phi(float z) {
  return __fmul_rn(0.5f, __fadd_rn(1.f, erf_as(__fmul_rn(z, kSqrt2Inv))));
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
}

// Normalised weights w[x] / (1e-9 + sum w), the sum taken left to right.
__device__ __forceinline__ void normalise(float* w, int M) {
  float wsum = 0.f;
  for (int x = 0; x < M; ++x) wsum = __fadd_rn(wsum, w[x]);
  const float den = __fadd_rn(1e-9f, wsum);
  for (int x = 0; x < M; ++x) w[x] = __fdiv_rn(w[x], den);
}

// One warp writes one pixel's table row: cdf_at(pt) is the mixture CDF at a
// sampling point; the row is quantised to 2^16 - (P - 1), made monotone by
// a running max, lifted by the column index, and its last entry is 2^16.
// Returns (in lane 0) the entries at sym and sym + 1.
template <typename CdfAt>
__device__ __forceinline__ void write_row(const float* __restrict__ pts, int P,
                                          int lane, int* __restrict__ out,
                                          int sym, int& lo, int& hi,
                                          CdfAt cdf_at) {
  const float new_max = (float)(65536 - (P - 1));
  int carry = INT_MIN;
  lo = 0;
  hi = 0;
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    int q = INT_MIN;
    if (p < P) {
      const float acc = cdf_at(pts[p]);
      q = (int)rintf(__fmul_rn(fminf(fmaxf(acc, 0.f), 1.f), new_max));
    }
    for (int off = 1; off < 32; off <<= 1) {  // inclusive running max
      const int o = __shfl_up_sync(kFull, q, off);
      if (lane >= off) q = max(q, o);
    }
    q = max(q, carry);
    carry = __shfl_sync(kFull, q, 31);
    if (p < P) {
      const int v = p == P - 1 ? 65536 : q + p;
      out[p] = v;
      if (p == sym) lo = v;
      if (p == sym + 1) hi = v;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {  // one lane holds each value
    lo += __shfl_down_sync(kFull, lo, off);
    hi += __shfl_down_sync(kFull, hi, off);
  }
}

template <bool kLogistic>
__global__ void cdf_pmap_kernel(const float* __restrict__ pts,
                                const float* __restrict__ pmap,
                                const float* __restrict__ y,
                                int* __restrict__ cum, int* __restrict__ start,
                                int* __restrict__ freq, int n, int P, int CO,
                                int YC, int M, int std0, int mean0, int w0,
                                int n_upd, int coef0, int ych0, int coef1,
                                int ych1, int sym_ch, int minv,
                                float scale_bound) {
  const int lane = threadIdx.x & 31;
  const long long pix =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= n) return;  // the whole warp leaves together
  const float* row = pmap + pix * CO;
  const float* yr = y + pix * YC;

  float mean[kMaxMixtures], inv[kMaxMixtures], w[kMaxMixtures];
  for (int x = 0; x < M; ++x) w[x] = fmaxf(row[w0 + x], kWeightBound);
  normalise(w, M);
  for (int x = 0; x < M; ++x) {
    inv[x] = __fdiv_rn(1.f, fmaxf(row[std0 + x], scale_bound));
    mean[x] = row[mean0 + x];
  }
  if (n_upd > 0)
    for (int x = 0; x < M; ++x)
      mean[x] = __fadd_rn(mean[x], __fmul_rn(row[coef0 + x], yr[ych0]));
  if (n_upd > 1)
    for (int x = 0; x < M; ++x)
      mean[x] = __fadd_rn(mean[x], __fmul_rn(row[coef1 + x], yr[ych1]));

  int sym = (int)rintf(__fmul_rn(yr[sym_ch], 255.f)) - minv;
  sym = min(max(sym, 0), P - 2);
  int lo, hi;
  write_row(pts, P, lane, cum + pix * P, sym, lo, hi, [&](float pt) {
    float acc = 0.f;
    for (int x = 0; x < M; ++x) {
      const float z = __fmul_rn(__fsub_rn(pt, mean[x]), inv[x]);
      acc = __fadd_rn(acc, __fmul_rn(w[x], kLogistic ? sigmoid(z) : phi(z)));
    }
    return acc;
  });
  if (lane == 0) {
    start[pix] = lo;
    freq[pix] = hi - lo;
  }
}

__global__ void cdf_table_kernel(const float* __restrict__ pts,
                                 const float* __restrict__ stdev,
                                 const float* __restrict__ means,
                                 const float* __restrict__ weights,
                                 int* __restrict__ cum, int n, int P, int X) {
  const int lane = threadIdx.x & 31;
  const long long pix =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= n) return;

  float mean[kMaxMixtures], sd[kMaxMixtures], w[kMaxMixtures];
  for (int x = 0; x < X; ++x) {
    w[x] = fmaxf(weights[pix * X + x], kWeightBound);
    sd[x] = fmaxf(stdev[pix * X + x], kScaleBoundNormal);
    mean[x] = means[pix * X + x];
  }
  normalise(w, X);
  int lo, hi;
  write_row(pts, P, lane, cum + pix * P, -2, lo, hi, [&](float pt) {
    float acc = 0.f;
    for (int x = 0; x < X; ++x) {
      const float z = __fdiv_rn(__fsub_rn(pt, mean[x]), sd[x]);
      acc = __fadd_rn(acc, __fmul_rn(w[x], phi(z)));
    }
    return acc;
  });
}

int blocks_for(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" int llicti_cdf_pmap(const float* pts, const float* pmap,
                               const float* y, int* cum, int* start, int* freq,
                               int n, int P, int CO, int YC, int M, int std0,
                               int mean0, int w0, int n_upd, int coef0,
                               int ych0, int coef1, int ych1, int sym_ch,
                               int minv, int logistic, float scale_bound,
                               void* stream) {
  if (M < 1 || M > kMaxMixtures || n_upd < 0 || n_upd > 2 || P < 2)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const dim3 grid(blocks_for(n)), block(kWarpsPerBlock * 32);
    cudaStream_t s = (cudaStream_t)stream;
    if (logistic)
      cdf_pmap_kernel<true><<<grid, block, 0, s>>>(
          pts, pmap, y, cum, start, freq, n, P, CO, YC, M, std0, mean0, w0,
          n_upd, coef0, ych0, coef1, ych1, sym_ch, minv, scale_bound);
    else
      cdf_pmap_kernel<false><<<grid, block, 0, s>>>(
          pts, pmap, y, cum, start, freq, n, P, CO, YC, M, std0, mean0, w0,
          n_upd, coef0, ych0, coef1, ych1, sym_ch, minv, scale_bound);
  }
  return (int)cudaGetLastError();
}

extern "C" int llicti_cdf_table(const float* pts, const float* stdev,
                                const float* means, const float* weights,
                                int* cum, int n, int P, int X, void* stream) {
  if (X < 1 || X > kMaxMixtures || P < 2) return (int)cudaErrorInvalidValue;
  if (n > 0)
    cdf_table_kernel<<<blocks_for(n), kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(pts, stdev, means, weights, cum,
                                               n, P, X);
  return (int)cudaGetLastError();
}

extern "C" const char* llicti_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
