// The widen of a container's rANS words on the card.
//
// It replaces no TPU kernel.  A container stores each image's stream as
// 16-bit words; Kernel 2 (rans.cu) reads them from int32 rows [K, W], one
// row an image, zero past each stream's end.  The decoder copies the
// 16-bit words to the card as the container holds them, each row
// unwritten past its stream's length, and this kernel writes the int32
// rows: dst[k, c] = c < len[k] ? src[k, c] : 0 for the columns c in
// [c0, c1), the words read as unsigned.  The two-stage decode widens its
// head and its tail columns in two launches, on two streams.
//
// It is bound by bytes: 2 read (only below a row's length) and 4 written a
// word.  One thread a column, gridDim.y rows at a time; a warp reads 64
// contiguous bytes and writes 128, whole 32-byte sectors.
#include <cuda_runtime.h>

namespace llicti {

constexpr int kWidenThreads = 256;
constexpr long long kWidenMaxBlocksX = 4096;
constexpr int kWidenMaxBlocksY = 65535;

__global__ void __launch_bounds__(kWidenThreads)
    widen_words_kernel(const unsigned short* __restrict__ src,
                       long long src_stride,
                       const long long* __restrict__ lengths,
                       int* __restrict__ dst, long long dst_stride,
                       long long c0, long long c1, int K) {
  const long long step = (long long)gridDim.x * kWidenThreads;
  for (int k = blockIdx.y; k < K; k += gridDim.y) {
    const long long len = lengths[k];
    const unsigned short* s = src + (long long)k * src_stride;
    int* d = dst + (long long)k * dst_stride;
    for (long long c = c0 + (long long)blockIdx.x * kWidenThreads +
                       threadIdx.x;
         c < c1; c += step)
      d[c] = c < len ? (int)s[c] : 0;
  }
}

}  // namespace llicti

// src: K rows of 16-bit words src_stride apart; lengths: int64 [K] on the
// card; dst: K int32 rows dst_stride apart.  Writes columns [c0, c1).
extern "C" int llicti_widen_words(const unsigned short* src,
                                  long long src_stride,
                                  const long long* lengths, int* dst,
                                  long long dst_stride, long long c0,
                                  long long c1, int K, void* stream) {
  using namespace llicti;
  if (K < 0 || c0 < 0 || c1 < c0 || (K > 1 && (src_stride < c1 ||
                                                dst_stride < c1)))
    return (int)cudaErrorInvalidValue;
  if (K == 0 || c1 == c0) return (int)cudaGetLastError();
  long long bx = (c1 - c0 + kWidenThreads - 1) / kWidenThreads;
  if (bx > kWidenMaxBlocksX) bx = kWidenMaxBlocksX;
  const dim3 grid((unsigned)bx,
                  (unsigned)(K < kWidenMaxBlocksY ? K : kWidenMaxBlocksY));
  widen_words_kernel<<<grid, kWidenThreads, 0, (cudaStream_t)stream>>>(
      src, src_stride, lengths, dst, dst_stride, c0, c1, K);
  return (int)cudaGetLastError();
}
