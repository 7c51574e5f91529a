// Kernels 2 and 3: the interleaved rANS decode and encode lane scans.
//
// Replace llicti_tpu/coder/rans_device.py:rans_decode_body_batch and
// rans_encode_body_batch, which the JAX package writes as XLA lax.scans
// over the steps of one slice.  Coder: N lanes share one stream of 16-bit
// words, states live in [2^16, 2^32), probabilities have 16 bits; symbol i
// of a slice belongs to step i / N and lane i % N.
//
// What bounds them on the H100: the scan is sequential in the steps, so
// one slice gives one block of N <= 1024 threads and the card is almost
// idle: the cost is latency, T = ceil(n / N) steps of a dependent state
// update, a word exchange between lanes and two block barriers each.
// Design: one launch per slice (not one per step), one lane per thread,
// states in registers for the whole slice; the word a lane refills from
// (decode) or writes to (encode) is found by a warp ballot plus a
// per-warp count in shared memory.  Lane states and the word offset carry
// from slice to slice through device memory.
//
// Integer-only, so the results equal the JAX scans bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kRansL = 1u << 16;

__device__ __forceinline__ unsigned warp_mask(int warp, int nwarps, int N) {
  return (warp == nwarps - 1 && (N & 31)) ? ((1u << (N & 31)) - 1u)
                                          : 0xffffffffu;
}

// Decode one slice of n symbols: cum [n, P] int32 rows, strictly
// increasing with cum[P-1] == 2^16 (cum[0] may be > 0).
__global__ void rans_decode_kernel(const int* __restrict__ cum,
                                   const int* __restrict__ words,
                                   long long n_words,
                                   long long* __restrict__ states,
                                   int* __restrict__ offset,
                                   int* __restrict__ syms, int n, int P) {
  __shared__ int warp_count[32];
  const int N = blockDim.x, l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5, nwarps = (N + 31) >> 5;
  const unsigned mask = warp_mask(warp, nwarps, N);
  unsigned x = (unsigned)states[l];
  long long off = *offset;
  const int T = (n + N - 1) / N;
  for (int t = 0; t < T; ++t) {
    const int i = t * N + l;
    const bool val = i < n;
    bool need = false;
    unsigned xn = x;
    int s = 0;
    if (val) {
      const int* row = cum + (long long)i * P;
      const unsigned slot = x & 0xFFFFu;
      // s = (number of entries <= slot) - 1: the masked reductions of the
      // JAX scan, found by binary search on the increasing row
      int lo = 0, hi = P;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] <= (int)slot) lo = mid + 1; else hi = mid;
      }
      s = lo - 1;
      const unsigned start = s >= 0 ? (unsigned)row[s] : 0u;
      const unsigned nxt = s + 1 < P ? (unsigned)row[s + 1] : kRansL;
      xn = (nxt - start) * (x >> 16) + slot - start;
      need = xn < kRansL;
    }
    // refilling lanes read consecutive words in lane order 0..N-1
    const unsigned ballot = __ballot_sync(mask, need);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int k = 0; k < nwarps; ++k) {
      const int c = warp_count[k];
      before += k < warp ? c : 0;
      total += c;
    }
    __syncthreads();
    if (val) {
      if (need) {
        const long long idx =
            off + before + __popc(ballot & ((1u << lane) - 1u));
        const unsigned w = idx < n_words ? (unsigned)words[idx] : 0u;
        xn = (xn << 16) | w;
      }
      x = xn;
      syms[i] = s;
    }
    off += total;
  }
  states[l] = (long long)x;
  if (l == 0) *offset = (int)off;
}

// Encode one slice in reverse step order.  Within a step the emitted
// words are placed in lane order N-1..0 at cursor + the exclusive count of
// the emitting lanes before them; freq 0 marks a masked no-op.
__global__ void rans_encode_kernel(const int* __restrict__ starts,
                                   const int* __restrict__ freqs,
                                   long long* __restrict__ states,
                                   int* __restrict__ cursor,
                                   int* __restrict__ buf, int cap, int n) {
  __shared__ int warp_count[32];
  const int N = blockDim.x, l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5, nwarps = (N + 31) >> 5;
  const unsigned mask = warp_mask(warp, nwarps, N);
  unsigned x = (unsigned)states[l];
  long long cur = *cursor;
  const int T = (n + N - 1) / N;
  for (int t = T - 1; t >= 0; --t) {
    const int i = t * N + l;
    unsigned start = 0u, freq = 0u;
    if (i < n) {
      start = (unsigned)starts[i];
      freq = (unsigned)freqs[i];
    }
    const bool val = freq > 0u;
    const unsigned fs = freq > 0u ? freq : 1u;
    const bool emit = val && x >= (fs << 16);
    const unsigned word = x & 0xFFFFu;
    const unsigned xs = emit ? x >> 16 : x;
    x = val ? ((xs / fs) << 16) + (xs % fs) + start : xs;
    const unsigned ballot = __ballot_sync(mask, emit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int after = 0, total = 0;
    for (int k = 0; k < nwarps; ++k) {
      const int c = warp_count[k];
      after += k > warp ? c : 0;
      total += c;
    }
    __syncthreads();
    if (emit) {
      // 2u << 31 wraps to 0, so lane 31 has no higher lanes in its warp
      const long long pos =
          cur + after + __popc(ballot & ~((2u << lane) - 1u));
      if (pos < cap) buf[pos] = (int)word;
    }
    cur += total;
  }
  states[l] = (long long)x;
  if (l == 0) *cursor = (int)cur;
}

}  // namespace

extern "C" int llicti_rans_decode(const int* cum, const int* words,
                                  long long n_words, long long* states,
                                  int* offset, int* syms, int n, int P, int N,
                                  void* stream) {
  if (N < 1 || N > 1024 || P < 2) return (int)cudaErrorInvalidValue;
  if (n > 0)
    rans_decode_kernel<<<1, N, 0, (cudaStream_t)stream>>>(
        cum, words, n_words, states, offset, syms, n, P);
  return (int)cudaGetLastError();
}

extern "C" int llicti_rans_encode(const int* starts, const int* freqs,
                                  long long* states, int* cursor, int* buf,
                                  int cap, int n, int N, void* stream) {
  if (N < 1 || N > 1024) return (int)cudaErrorInvalidValue;
  if (n > 0)
    rans_encode_kernel<<<1, N, 0, (cudaStream_t)stream>>>(
        starts, freqs, states, cursor, buf, cap, n);
  return (int)cudaGetLastError();
}
