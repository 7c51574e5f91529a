// Kernel 1's C entry points (the kernels are in cdf.cuh; the logistic
// branch's instances compile in cdf_pmap_logistic.cu, in parallel).
#include "cdf.cuh"

namespace llicti {

template int launch_cdf_pmap<false>(const PmapArgs&, int, cudaStream_t);
template int occupancy_cdf_pmap<false>(int);

namespace {

// Every float x with |x| > kErfSaturated must give Phi exactly 1 or 0 by
// the full formula: the shortcut of normal_term.  Counts the inputs that
// break this.
__global__ void check_saturation_kernel(unsigned long long* bad) {
  unsigned long long count = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long b = blockIdx.x * blockDim.x + threadIdx.x;
       b < (1ull << 32); b += stride) {
    const float v = __uint_as_float((unsigned)b);
    if (fabsf(v) > kErfSaturated &&
        __float_as_uint(phi_x(v)) != __float_as_uint(v > 0.f ? 1.f : 0.f))
      ++count;
  }
  atomicAdd(bad, count);
}

}  // namespace
}  // namespace llicti

extern "C" int llicti_cdf_pmap(const float* pts, const float* pmap,
                               const float* y, int* cum, int* start, int* freq,
                               int n, int P, int CO, int YC, int M, int std0,
                               int mean0, int w0, int n_upd, int coef0,
                               int ych0, int coef1, int ych1, int sym_ch,
                               int minv, int logistic, float scale_bound,
                               void* stream) {
  using namespace llicti;
  if (M < 1 || M > kMaxMixtures || n_upd < 0 || n_upd > 2 || P < 2)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const PmapArgs a{pts,   pmap,  y,     cum,   start, freq,   n,
                   P,     CO,    YC,    std0,  mean0, w0,     n_upd,
                   coef0, ych0,  coef1, ych1,  sym_ch, minv, scale_bound};
  cudaStream_t s = (cudaStream_t)stream;
  return logistic ? launch_cdf_pmap<true>(a, M, s)
                  : launch_cdf_pmap<false>(a, M, s);
}

// Resident blocks per SM of Kernel 1 and its threads per block.
extern "C" int llicti_cdf_pmap_occupancy(int M, int logistic, int* threads) {
  *threads = llicti::kThreads;
  return logistic ? llicti::occupancy_cdf_pmap<true>(M)
                  : llicti::occupancy_cdf_pmap<false>(M);
}

extern "C" int llicti_cdf_check_saturation(unsigned long long* bad,
                                           void* stream) {
  llicti::check_saturation_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      bad);
  return (int)cudaGetLastError();
}

extern "C" const char* llicti_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
