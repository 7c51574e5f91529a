// Kernel 1: the quantised GMM CDF table, straight from the conv output.
//
// Replaces llicti_tpu/ops/cdf_pallas.py:gmm_cdf_from_pmap_pallas (kernel
// body _cdf_pmap_kernel).  Per pixel it slices std, mean and weight out of
// the channel-minor pmap row, bounds them, applies the cross-colour mean
// updates, sums the M-mixture normal CDF at P sampling points, quantises
// to the coder's 16-bit contract and emits the encoder's (start, freq) at
// the pixel's true symbol.
//
// What bounds it on the H100: the kernel is write-bound, 0.5-2 KB of int32
// table per pixel (P = 257 or 513), against a few hundred bytes read.
// Design: one warp per pixel walks the row in chunks of 32 consecutive
// entries, so every table store is one coalesced 128-byte line; the running
// max along P is a warp shuffle scan plus a carry between chunks; the
// per-pixel parameters stay in registers.  No shared memory.
//
// Numerics follow the Pallas kernel operation for operation (A&S 7.1.26
// erf, not erff; round half to even; the same sums in the same order).
// The __f*_rn intrinsics keep nvcc from contracting a multiply and an add
// into one FMA, which would round differently.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxMixtures = 16;
constexpr float kScaleBound = (float)(0.11 / 255.0);
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

__global__ void cdf_pmap_kernel(const float* __restrict__ pts,
                                const float* __restrict__ pmap,
                                const float* __restrict__ y,
                                int* __restrict__ cum, int* __restrict__ start,
                                int* __restrict__ freq, int n, int P, int CO,
                                int YC, int M, int std0, int mean0, int w0,
                                int n_upd, int coef0, int ych0, int coef1,
                                int ych1, int sym_ch, int minv) {
  const int lane = threadIdx.x & 31;
  const long long pix =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= n) return;  // the whole warp leaves together
  const float* row = pmap + pix * CO;
  const float* yr = y + pix * YC;

  float mean[kMaxMixtures], inv[kMaxMixtures], w[kMaxMixtures];
  float wsum = 0.f;
  for (int x = 0; x < M; ++x) {
    w[x] = fmaxf(row[w0 + x], kWeightBound);
    wsum = __fadd_rn(wsum, w[x]);
  }
  const float den = __fadd_rn(1e-9f, wsum);
  for (int x = 0; x < M; ++x) {
    w[x] = __fdiv_rn(w[x], den);
    inv[x] = __fdiv_rn(1.f, fmaxf(row[std0 + x], kScaleBound));
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
  const float new_max = (float)(65536 - (P - 1));
  int* out = cum + pix * P;
  int carry = INT_MIN, lo = 0, hi = 0;
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    int q = INT_MIN;
    if (p < P) {
      const float pt = pts[p];
      float acc = 0.f;
      for (int x = 0; x < M; ++x) {
        const float z = __fmul_rn(__fsub_rn(pt, mean[x]), inv[x]);
        acc = __fadd_rn(acc, __fmul_rn(w[x], phi(z)));
      }
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
  if (lane == 0) {
    start[pix] = lo;
    freq[pix] = hi - lo;
  }
}

}  // namespace

extern "C" int llicti_cdf_pmap(const float* pts, const float* pmap,
                               const float* y, int* cum, int* start, int* freq,
                               int n, int P, int CO, int YC, int M, int std0,
                               int mean0, int w0, int n_upd, int coef0,
                               int ych0, int coef1, int ych1, int sym_ch,
                               int minv, void* stream) {
  if (M < 1 || M > kMaxMixtures || n_upd < 0 || n_upd > 2 || P < 2)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cdf_pmap_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        pts, pmap, y, cum, start, freq, n, P, CO, YC, M, std0, mean0, w0,
        n_upd, coef0, ych0, coef1, ych1, sym_ch, minv);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* llicti_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
