// Kernel 4: the CDF table from pre-sliced std / mean / weight (see
// cdf.cuh for what it replaces, what bounds it and the shared design).
#include "cdf.cuh"

namespace llicti {
namespace {

template <int X>
__global__ void LLICTI_CDF_BOUNDS
    cdf_table_kernel(const float* __restrict__ pts,
                     const float* __restrict__ stdev,
                     const float* __restrict__ means,
                     const float* __restrict__ weights, int* __restrict__ cum,
                     int n, int P) {
  const int gl = threadIdx.x % kLanes;
  if (warp_first_pixel(threadIdx.x) >= n) return;
  const long long pix =
      (long long)blockIdx.x * kPixelsPerBlock + threadIdx.x / kLanes;
  const bool active = pix < n;
  const long long pp = active ? pix : n - 1;  // computed, not stored

  float mean[X], sd[X], w[X];
#pragma unroll
  for (int x = 0; x < X; ++x) {
    w[x] = fmaxf(weights[pp * X + x], kWeightBound);
    sd[x] = fmaxf(stdev[pp * X + x], kScaleBoundNormal);
    mean[x] = means[pp * X + x];
  }
  normalise(w);
  int lo, hi;
  write_row(pts, P, gl, active ? cum + pix * P : nullptr, -2, lo, hi,
            [&](float pt) {
              float acc = 0.f;
#pragma unroll
              for (int x = 0; x < X; ++x)
                acc = __fadd_rn(acc, normal_term(__fdiv_rn(
                                         __fsub_rn(pt, mean[x]), sd[x]), w[x]));
              return acc;
            });
}

}  // namespace
}  // namespace llicti

extern "C" int llicti_cdf_table(const float* pts, const float* stdev,
                                const float* means, const float* weights,
                                int* cum, int n, int P, int X, void* stream) {
  using namespace llicti;
  if (X < 1 || X > kMaxMixtures || P < 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 grid(blocks_for(n)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
#define LLICTI_TABLE_CASE(x)                                             \
  case x:                                                                \
    cdf_table_kernel<x><<<grid, block, 0, s>>>(pts, stdev, means, weights, \
                                               cum, n, P);               \
    break;
    LLICTI_TABLE_CASE(1) LLICTI_TABLE_CASE(2) LLICTI_TABLE_CASE(3)
    LLICTI_TABLE_CASE(4) LLICTI_TABLE_CASE(5) LLICTI_TABLE_CASE(6)
    LLICTI_TABLE_CASE(7) LLICTI_TABLE_CASE(8) LLICTI_TABLE_CASE(9)
    LLICTI_TABLE_CASE(10) LLICTI_TABLE_CASE(11) LLICTI_TABLE_CASE(12)
    LLICTI_TABLE_CASE(13) LLICTI_TABLE_CASE(14) LLICTI_TABLE_CASE(15)
    LLICTI_TABLE_CASE(16)
#undef LLICTI_TABLE_CASE
  }
  return (int)cudaGetLastError();
}
