// Kernels 2 and 3: the interleaved rANS decode and encode lane scans.
//
// Replace llicti_tpu/coder/rans_device.py:rans_decode_body_batch and
// rans_encode_body_batch, which the JAX package writes as XLA lax.scans
// over the steps of one slice.  Coder: N lanes share one stream of 16-bit
// words, states live in [2^16, 2^32), probabilities have 16 bits; symbol i
// of a slice belongs to step i / N and lane i % N.
//
// What bounds them on the H100: the scan is sequential in the steps, so a
// slice runs on one block or one small cluster and the rest of the card
// idles.  Bytes are no limit (a few MB per slice); latency is.  A decode
// step waits on its lanes' table searches: each probe is a dependent load,
// and the table (up to 100 MB a slice) mostly misses L2, so the first
// probes cost a device-memory round trip each; on one block a step cost
// ~1 us of barrier, words and one probe plus ~0.5 us per further probe
// level (decode of synthetic tables of P = 2 ... 513, PERF.md).  The
// encode costs T = ceil(n / N) dependent steps.
//
// Both: one launch per slice, one lane per thread, states in registers for
// the whole slice; the word a lane refills from (decode) or writes to
// (encode) is its rank among the lanes that refill, a warp ballot plus an
// exclusive prefix over per-warp counts in shared memory.  Lane states and
// the word offset carry from slice to slice through device memory.
//
// Integer-only, so the results equal the JAX scans bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kRansL = 1u << 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLanes = 1024;
// The decode's shape, the fastest of those timed on the finest Y slice
// (PERF.md): a cluster of 8 blocks, and 7 coarse entries per row.
constexpr int kCluster = 8;
constexpr int kCoarse = 7;

__device__ __forceinline__ unsigned warp_mask(int warp, int nwarps, int N) {
  return (warp == nwarps - 1 && (N & 31)) ? ((1u << (N & 31)) - 1u)
                                          : 0xffffffffu;
}

// Decode one slice of n symbols: cum [n, P] int32 rows, strictly
// increasing with cum[P-1] == 2^16 (cum[0] may be > 0).
//
// Each step searches every lane's row for s = (entries <= slot) - 1, the
// masked reductions of the JAX scan, by binary search.  Design:
//  * The lanes are split over the kCluster blocks of one thread-block
//    cluster, one block per SM, so that kCluster load pipelines serve the
//    searches; the blocks exchange their per-warp refill counts through
//    distributed shared memory, one cluster barrier per step.  This
//    replaces a one-block design: on one SM, which queues every lane's
//    probes, one block took 0.450 ms on the finest Y slice, 0.714 with
//    coarse entries and 0.821 with an L2 bulk prefetch of the next steps'
//    rows, against 0.296 for this kernel (PERF.md).
//  * The search keeps the entries that bound it, so start = cum[s] and
//    next = cum[s + 1] cost no further load: ceil(log2(P + 1)) line
//    requests per lane and step.
//  * The words a step may read (at most N, in stream order) are loaded at
//    the step's start, coalesced, into registers, and staged in shared
//    memory before the barrier, so the refill is a shared-memory read.
//  * One barrier per step: the per-warp counts and the staged words are
//    double-buffered by step parity, and the warps' exclusive prefix is a
//    shuffle scan over the (at most 32) warps of the cluster.
//  * kCoarse entries of each row, at columns (k + 1) P / (kCoarse + 1),
//    are loaded into registers one step ahead (the next step's rows are
//    known before this step ends), so the fine search covers one span of
//    ~P / (kCoarse + 1) entries, one or two lines.
// Block b holds lanes [b * blockDim, (b + 1) * blockDim); threads past N
// hold no lane.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kMaxLanes, 1)
    rans_decode_kernel(const int* __restrict__ cum,
                       const int* __restrict__ words, long long n_words,
                       long long* __restrict__ states,
                       int* __restrict__ offset, int* __restrict__ syms,
                       int n, int P, int N) {
  __shared__ int warp_count[2][32];
  __shared__ int staged[2][kMaxLanes];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int nt = blockDim.x;
  const int l = b * nt + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = nt >> 5;  // per block; kCluster * nwarps <= 32
  const bool live = l < N;
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned x = live ? (unsigned)states[l] : 0u;
  long long off = *offset;
  const int T = (n + N - 1) / N;

  int pos[kCoarse], coarse[kCoarse];
#pragma unroll
  for (int k = 0; k < kCoarse; ++k)
    pos[k] = (int)((long long)(k + 1) * P / (kCoarse + 1));
  if (live && l < n) {
    const int* row = cum + (long long)l * P;
#pragma unroll
    for (int k = 0; k < kCoarse; ++k) coarse[k] = row[pos[k]];
  }

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    const int i = t * N + l;
    const bool val = live && i < n;
    int word[kCluster];  // staged below: every block holds the step's words
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int j = r * nt + threadIdx.x;
      word[r] = j < N && off + j < n_words ? words[off + j] : 0;
    }
    bool need = false;
    unsigned xn = x;
    int s = 0;
    if (val) {
      const int slot = (int)(x & 0xFFFFu);
      // invariant: entries before lo are <= slot, those from hi on are
      // > slot; sv = cum[lo - 1] (0 if lo == 0), nv = cum[hi] (2^16 if
      // hi == P)
      int lo = 0, hi = P, sv = 0, nv = (int)kRansL;
#pragma unroll
      for (int k = 0; k < kCoarse; ++k)
        if (coarse[k] <= slot) { lo = pos[k] + 1; sv = coarse[k]; }
#pragma unroll
      for (int k = kCoarse - 1; k >= 0; --k)
        if (coarse[k] > slot) { hi = pos[k]; nv = coarse[k]; }
      if (i + N < n) {  // the next step's coarse entries, in flight now
        const int* nrow = cum + (long long)(i + N) * P;
#pragma unroll
        for (int k = 0; k < kCoarse; ++k) coarse[k] = nrow[pos[k]];
      }
      const int* row = cum + (long long)i * P;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int v = row[mid];
        if (v <= slot) { lo = mid + 1; sv = v; } else { hi = mid; nv = v; }
      }
      s = lo - 1;
      const unsigned start = (unsigned)sv;
      xn = ((unsigned)nv - start) * (x >> 16) + (unsigned)slot - start;
      need = xn < kRansL;
    }
    // refilling lanes read consecutive words in lane order 0..N-1
    const unsigned ballot = __ballot_sync(kFull, need);
    if (lane == 0) warp_count[par][warp] = __popc(ballot);
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      if (r * nt + threadIdx.x < kMaxLanes)
        staged[par][r * nt + threadIdx.x] = word[r];
    cluster.sync();
    int c = 0;  // lane k holds the count of the cluster's warp k
    if (lane < kCluster * nwarps)
      c = *cluster.map_shared_rank(&warp_count[par][lane % nwarps],
                                   lane / nwarps);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int before = __shfl_sync(kFull, incl - c, b * nwarps + warp);
    if (val) {
      if (need)
        xn = (xn << 16) |
             (unsigned)staged[par][before + __popc(ballot & lanes_below)];
      x = xn;
      syms[i] = s;
    }
    off += total;
  }
  if (live) states[l] = (long long)x;
  if (l == 0) *offset = (int)off;
  // no block leaves while another may still read its counts
  cluster.sync();
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
  if (N < 1 || N > kMaxLanes || P < 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // lanes per block: N / kCluster rounded up to whole warps (<= 1024 / 8)
  const int threads = ((N + kCluster - 1) / kCluster + 31) & ~31;
  rans_decode_kernel<<<kCluster, threads, 0, (cudaStream_t)stream>>>(
      cum, words, n_words, states, offset, syms, n, P, N);
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
