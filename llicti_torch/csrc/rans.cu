// Kernels 2 and 3: the interleaved rANS decode and encode lane scans.
//
// Replace llicti_tpu/coder/rans_device.py:rans_decode_body_batch and
// rans_encode_body_batch, which the JAX package writes as XLA lax.scans
// over the steps of one slice, and, for the encode, the loop over an
// image's slices in llicti_tpu/codec.py (do_chain, rans_encode_group).
// Coder: N lanes share one stream of 16-bit words, states live in
// [2^16, 2^32), probabilities have 16 bits; symbol i of a slice belongs to
// step i / N and lane i % N.  N is any count from 1 up, as in the JAX
// scans.
//
// What bounds them on the H100: the scans are sequential in the steps.
// Bytes are no limit (a few MB per slice); latency is.  A decode step
// waits on its lanes' table searches: each probe is a dependent load, and
// the table (up to 100 MB a slice) mostly misses L2, so the first probes
// cost a device-memory round trip each; on one block a step cost ~1 us of
// barrier, words and one probe plus ~0.5 us per further probe level
// (decode of synthetic tables of P = 2 ... 513, PERF.md).
//
// Decode: one launch per slice (a slice's tables depend on the slices
// decoded before it), one lane per thread, states in registers for the
// whole slice; the word a lane refills from is its rank among the lanes
// that refill, a warp ballot plus an exclusive prefix over per-warp
// counts.  Lane states and the word offset carry from slice to slice
// through device memory.  A batch of K images (the batch container)
// decodes its K slices in the same launch, one cluster per image.  Up to
// 1024 lanes: rans_decode_kernel, a cluster of 8 blocks of at most 128
// threads.  Above: rans_decode_wide_kernel, the same step on a cluster of
// 16 blocks of up to 1024 threads (16384 lanes), with a two-level prefix;
// wider still, each thread takes its lanes in chunks.
//
// Encode: every slice's (start, freq) is known before the first one is
// encoded, so an image's whole chain is one call of two launches, and so
// are the K chains of a batch (blockIdx.y is the image).  What
// bounds it is the chain's dependent steps (sum of ceil(n_s / N), 1,161
// for 512x768 at N = 1024), not its bytes (~11 MB, 3 us at 3.35 TB/s): a
// lane's step is a compare, a select, a 32-bit division and a
// multiply-add on its state, ~90 ns with the step's other work (PERF.md).
// The design keeps all else off that chain; see "Kernel 3" below.
//
// Integer-only, so the results equal the JAX scans bit for bit.
#include <climits>
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
// Above kMaxLanes lanes the decode runs rans_decode_wide_kernel: clusters
// of kWideCluster blocks (non-portable: the H100 allows 16) of at most
// kWideThreads threads.
constexpr int kWideThreads = 1024;
constexpr int kWideCluster = 16;
constexpr int kWideClusterBits = kWideCluster == 16 ? 4 : 3;
static_assert(kWideCluster == 8 || kWideCluster == 16, "a power of two");
// Lanes, word offsets and symbol indices are 32-bit in the kernels.
constexpr int kMaxLaneCount = 1 << 30;

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
// hold no lane.  Cluster k decodes image k of a batch: its rows
// cum[k n, (k + 1) n), its word row words[k * words_stride, + n_words)
// (zeros past it, as the JAX scan reads), states[k], offset[k] and
// syms[k n, (k + 1) n).  A K above the card's resident clusters runs in
// waves.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kMaxLanes, 1)
    rans_decode_kernel(const int* __restrict__ cum,
                       const int* __restrict__ words, long long n_words,
                       long long words_stride,
                       long long* __restrict__ states,
                       int* __restrict__ offset, int* __restrict__ syms,
                       int n, int P, int N) {
  __shared__ int warp_count[2][32];
  __shared__ int staged[2][kMaxLanes];
  const long long img = blockIdx.x / kCluster;
  cum += img * n * P;
  words += img * words_stride;
  states += img * N;
  offset += img;
  syms += img * n;
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

// The decode above kMaxLanes lanes.  Same arguments, batch layout and
// result as rans_decode_kernel; R is the lanes a thread holds.
//
// What bounds it: as in the narrow kernel, a step waits on its searches'
// dependent loads and one cluster barrier; and the loads of all the
// lanes an SM serves queue there, so a step costs more the more lanes an
// SM holds (on the finest Y slice: ~3.0 us at 128 lanes an SM, ~10 us at
// 1024; PERF.md).  The kernel's first version ran 1024 threads on 8
// SMs whatever N, each searching up to 16 rows in lockstep through ~9
// dependent probe levels, and read its refill words from device memory
// after the barrier: 11.6 us a step at N = 2048.  This design:
//  * One lane a thread over 16 SMs: a cluster of C = kWideCluster blocks
//    of B <= kWideThreads threads (N / C rounded up to whole warps), so
//    2048 lanes run 128 threads on each of 16 SMs, the narrow kernel's
//    load per SM.  C = 16 beat C = 8 at every N timed, 1025 to 131072
//    (3.02 against 3.50 us a step at N = 2048, 10.0 against 16.8 at
//    16384).  Past C *
//    kWideThreads lanes a thread holds R lanes, one of each chunk of CT =
//    C B consecutive lanes; a step runs its chunks in lane order as
//    sub-steps, each with one step's work and barrier, and a chunked
//    lane's state waits in `states` between its sub-steps (its load one
//    sub-step ahead), so no lane count is built in.
//  * kCoarse entries of the next sub-step's rows in registers one
//    sub-step ahead, so the fine search spans one or two lines.
//  * The sub-step's word window [off, off + CT) (a chunk reads at most CT
//    words) is loaded at its start, one coalesced word a thread, and
//    staged in shared memory before the barrier, 32-word groups dealt to
//    the blocks in turn; a refill reads its word from the block that
//    holds it through distributed shared memory.
//  * A two-level prefix and one cluster barrier a sub-step: a warp's
//    ballot count goes to shared memory and to its block's total (a
//    shared-memory atomic); after the barrier a warp scans its block's
//    (at most 32) warp counts and sums the totals of the blocks below it
//    (one remote read a lane, __reduce_add_sync), so refills keep lane
//    order 0..N-1.  Warp counts and words are double-buffered by
//    sub-step parity; block totals rotate through three slots, the one
//    of the sub-step before last cleared after each barrier.
__global__ void __launch_bounds__(kWideThreads, 1)
    rans_decode_wide_kernel(const int* __restrict__ cum,
                            const int* __restrict__ words, long long n_words,
                            long long words_stride,
                            long long* __restrict__ states,
                            int* __restrict__ offset, int* __restrict__ syms,
                            int n, int P, int N, int R) {
  __shared__ int warp_count[2][32];
  __shared__ int block_count[3];
  __shared__ int staged[2][kWideThreads];
  constexpr int C = kWideCluster, cbits = kWideClusterBits;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const long long img = blockIdx.x >> cbits;
  cum += img * n * P;
  words += img * words_stride;
  states += img * N;
  offset += img;
  syms += img * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int CT = C * blockDim.x;
  const int g = b * blockDim.x + tid;  // the thread's rank in the cluster
  const unsigned lanes_below = (1u << lane) - 1u;
  // the window word this thread stages: group (warp C + b) of 32
  const int jw = (((warp << cbits) + b) << 5) + lane;
  const int nw = (int)min(n_words, (long long)INT_MAX);
  if (tid < 3) block_count[tid] = 0;
  __syncthreads();

  int pos[kCoarse], coarse[kCoarse];
#pragma unroll
  for (int k = 0; k < kCoarse; ++k) {
    pos[k] = (int)((long long)(k + 1) * P / (kCoarse + 1));
    coarse[k] = 0;
  }
  // sub-step: lane l of the step whose first symbol is base; i = base + l
  unsigned base = 0u;
  int l = g;
  bool val = l < N && l < n;
  unsigned x = l < N ? (unsigned)states[l] : 0u;
  if (val) {
    const int* row = cum + (long long)l * P;
#pragma unroll
    for (int k = 0; k < kCoarse; ++k) coarse[k] = row[pos[k]];
  }
  int off = *offset;
  const int last = R * CT - CT;  // the last chunk's first lane
  for (int u = 0, u3 = 0; base + (unsigned)(l - g) < (unsigned)n;
       ++u, u3 = u3 == 2 ? 0 : u3 + 1) {
    const int par = u & 1;
    const int word = jw < nw - off ? words[off + jw] : 0;
    // the next sub-step: the next chunk, or the first of the next step
    const bool wrap = l - g == last;
    const int ln = wrap ? g : l + CT;
    const unsigned bn = wrap ? base + (unsigned)N : base;
    const bool valn = ln < N && bn + (unsigned)ln < (unsigned)n;
    unsigned xnext = 0u;
    if (R > 1 && ln < N) xnext = (unsigned)states[ln];
    bool need = false;
    unsigned xn = x;
    int s = 0;
    const int slot = (int)(x & 0xFFFFu);
    // invariant as in rans_decode_kernel
    int lo = 0, hi = P, sv = 0, nv = (int)kRansL;
#pragma unroll
    for (int k = 0; k < kCoarse; ++k)
      if (coarse[k] <= slot) { lo = pos[k] + 1; sv = coarse[k]; }
#pragma unroll
    for (int k = kCoarse - 1; k >= 0; --k)
      if (coarse[k] > slot) { hi = pos[k]; nv = coarse[k]; }
    if (valn) {  // the next sub-step's coarse entries, in flight now
      const int* nrow = cum + (long long)(bn + (unsigned)ln) * P;
#pragma unroll
      for (int k = 0; k < kCoarse; ++k) coarse[k] = nrow[pos[k]];
    }
    const unsigned i = base + (unsigned)l;
    if (val) {
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
    const unsigned ballot = __ballot_sync(kFull, need);
    if (lane == 0) {
      warp_count[par][warp] = __popc(ballot);
      if (ballot) atomicAdd(&block_count[u3], __popc(ballot));
    }
    staged[par][tid] = word;
    cluster.sync();
    const int wc = lane < nwarps ? warp_count[par][lane] : 0;
    const int bc =
        lane < C ? *cluster.map_shared_rank(&block_count[u3], lane) : 0;
    int incl = wc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int before = __shfl_sync(kFull, incl - wc, warp) +
                       __reduce_add_sync(kFull, lane < b ? bc : 0);
    const int total = __reduce_add_sync(kFull, bc);
    // the sub-step before this one is read by no block any more
    if (tid == 0) block_count[u3 == 0 ? 2 : u3 - 1] = 0;
    if (val) {
      if (need) {
        const int r = before + __popc(ballot & lanes_below);
        const int q = r >> 5;
        xn = (xn << 16) |
             (unsigned)*cluster.map_shared_rank(
                 &staged[par][((q >> cbits) << 5) | (r & 31)], q & (C - 1));
      }
      x = xn;
      syms[i] = s;
    }
    off += total;
    if (R > 1) {
      if (l < N) states[l] = (long long)x;
      x = xnext;
    }
    l = ln;
    base = bn;
    val = valn;
  }
  if (R == 1 && g < N) states[g] = (long long)x;
  if (g == 0) *offset = off;
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// ---- Kernel 3: the encode chain ------------------------------------------
//
// An image's slices, concatenated in encode order (slice s holds symbols
// [off[s], off[s+1])), are encoded in two launches:
//  1. rans_encode_lanes_kernel: each lane carries its state through every
//     step of the chain (slices in order, steps T_s-1 ... 0 within a
//     slice), with no barrier and no traffic between lanes: a lane's
//     state, emit decisions and words depend only on its own symbols, as
//     in the JAX scan, which carries only the states.  One warp per block,
//     so the ceil(N / 32) warps sit on as many SMs and each lane's
//     dependent chain (compare, select, one division, multiply-add and
//     select per step) sets the time.  One warp issues in order, so
//     whatever else a step does adds to that chain unless it sits in the
//     same branch-free code: the steps run in unrolled blocks of kAhead
//     with no branch, the next block's (start, freq) in flight meanwhile
//     (the state decides none of them); lane j of the warp finds where
//     step g + j lies (slice bounds in shared memory) and the loads take
//     each step's place from it by a shuffle; lane k keeps step k's ballot
//     of the emit decisions and the warp's running word count, stored
//     once a block; each lane stores its words two steps to a 32-bit
//     word.  Scratch is padded to whole blocks, so no store needs a guard.
//  2. rans_encode_place_kernel: the JAX scan's placement.  A block takes
//     kPlace / W whole steps (kPlace entries of one step when W > kPlace,
//     N > 8192); the words before them are the W warps'
//     running counts at the step before (plus the step's earlier entries'
//     words when a block starts inside a step), the block's own entries are
//     prefixed in emission order (steps descending within a slice, warps
//     descending), and a word's rank among the higher lanes of its warp
//     completes its position.  Positions >= cap are dropped but counted
//     (JAX's mode="drop").  The running counts at a slice's last step give
//     its cursor.
// The division stays xs / fs with r = xs - q * fs.  The K chains of a
// batch share the plan (their images have one shape) and each has its own
// inputs, carry, output row and scratch region: blockIdx.y is the image in
// both launches.

constexpr int kAhead = 8;       // steps of a block; the next block in flight
constexpr int kPlace = 256;     // threads (entries) of a placement block
constexpr int kMaxSlices = 1024;
constexpr int kStepRound = 64;  // scratch holds the steps rounded up to this
static_assert(kStepRound % (2 * kAhead) == 0, "the loop runs 2 kAhead steps");

// The chain's shape, a kernel parameter: the slices' offsets and the
// chain's steps through each slice.
struct ChainPlan {
  int S;
  int off[kMaxSlices + 1];
  int ends[kMaxSlices];
};

__host__ __device__ __forceinline__ long long padded_steps(long long G) {
  return (G + kStepRound - 1) / kStepRound * kStepRound;
}

// The scratch of one chain of G steps over N lanes, in int32 words:
// entries uint2 [W Gp], then low uint32 [Gp / 2 * 32 W], then cursor0
// int64, with W = ceil(N / 32) and Gp = G rounded up to kStepRound.  An
// even count, so every image's region of a batch stays 8-byte aligned.
__host__ __device__ __forceinline__ long long scratch_words(long long G,
                                                           int N) {
  const long long W = (N + 31) / 32, Gp = padded_steps(G);
  return 2 * W * Gp + Gp / 2 * 32 * W + 2;
}

struct Scratch {
  uint2* entries;
  unsigned* low;
  long long* cursor0;
};

// Image img's region of a batch's scratch.
__device__ __forceinline__ Scratch scratch_of(int* scratch, long long G,
                                              int N, long long img) {
  const long long W = (N + 31) / 32, words = scratch_words(G, N);
  int* base = scratch + img * words;
  return {(uint2*)base, (unsigned*)(base + 2 * W * padded_steps(G)),
          (long long*)(base + words - 2)};
}

// A load that the compiler keeps where it is written, so that the next
// block's inputs are in flight while this block runs; 0 where !pred.
__device__ __forceinline__ unsigned ld_nc(const int* p, bool pred) {
  unsigned v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.u32 %0, 0;\n"
      " @q ld.global.nc.u32 %0, [%1];\n}"
      : "=r"(v)
      : "l"(p), "r"((int)pred));
  return v;
}

// Lane j < kAhead: where step g + j lies, its first symbol and its
// symbols (0 past the chain).  se: the steps through each slice; s, the
// lane's slice, only moves forward.
__device__ __forceinline__ void describe(const int* so, const int* se, int S,
                                         int N, int lane, long long g,
                                         int& s, int& first, int& count) {
  const long long gj = g + (lane < kAhead ? lane : 0);
  while (s < S && se[s] <= gj) ++s;
  first = count = 0;
  if (s < S) {
    const int t = se[s] - 1 - (int)gj;  // the step within slice s
    first = so[s] + t * N;
    count = min(N, so[s + 1] - first);
  }
}

// The inputs of a block of steps, lane l's of each (0 where the step
// holds no symbol for it); the steps' places come from describe.
__device__ __forceinline__ void load_block(const int* __restrict__ starts,
                                           const int* __restrict__ freqs,
                                           int first, int count, int l,
                                           unsigned (&st)[kAhead],
                                           unsigned (&fr)[kAhead]) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int fk = __shfl_sync(kFull, first, k);
    const bool has = l < __shfl_sync(kFull, count, k);
    const int i = has ? fk + l : 0;
    st[k] = ld_nc(starts + i, has);
    fr[k] = ld_nc(freqs + i, has);
  }
}

// kAhead steps of one lane's chain from step g0 on inputs (st, fr) loaded
// one block earlier, while the next block's inputs load into (nst, nfr).
// ep: this warp's entries from step g0; lp: this lane's words from g0.
__device__ __forceinline__ void run_block(
    const int* __restrict__ starts, const int* __restrict__ freqs,
    const int* so, const int* se, int S, int N, int l, int lane, int& ds,
    long long g0, int W, unsigned& x, int& run, const unsigned (&st)[kAhead],
    const unsigned (&fr)[kAhead], unsigned (&nst)[kAhead],
    unsigned (&nfr)[kAhead], uint2* __restrict__ ep,
    unsigned* __restrict__ lp) {
  int first, count;
  describe(so, se, S, N, lane, g0 + kAhead, ds, first, count);
  load_block(starts, freqs, first, count, l, nst, nfr);
  unsigned mb = 0u, mr = 0u, prev = 0u;
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const bool val = fr[k] > 0u;  // freq 0 marks a masked no-op
    const unsigned fs = val ? fr[k] : 1u;
    const bool emit = val && x >= (fs << 16);
    const unsigned word = x & 0xFFFFu;
    const unsigned xs = emit ? x >> 16 : x;
    const unsigned q = xs / fs;
    x = val ? (q << 16) + (xs - q * fs) + st[k] : xs;
    const unsigned ballot = __ballot_sync(kFull, emit);
    run += __popc(ballot);
    if (lane == k) {
      mb = ballot;
      mr = (unsigned)run;
    }
    if (k & 1) lp[(k >> 1) * 32 * W] = prev | (word << 16);
    prev = word;
  }
  if (lane < kAhead) ep[lane] = make_uint2(mb, mr);
}

// Block b holds lanes 32 b ... 32 b + 31; lanes past N hold no symbol (no
// step holds more than N).  entries: uint2 [W][padded G], warp-major in
// emission order (row W - 1 - b); low: uint32 [padded G / 2][32 W].
// blockIdx.y: the image, whose symbols start at img * plan.off[S].
__global__ void __launch_bounds__(32)
    rans_encode_lanes_kernel(const int* __restrict__ starts,
                             const int* __restrict__ freqs,
                             const __grid_constant__ ChainPlan plan,
                             long long G, long long* __restrict__ states,
                             const int* __restrict__ cursor,
                             int* __restrict__ scratch, int N) {
  extern __shared__ int smem[];
  const int S = plan.S;
  const long long img = blockIdx.y;
  starts += img * plan.off[S];
  freqs += img * plan.off[S];
  states += img * N;
  cursor += img;
  const Scratch sc = scratch_of(scratch, G, N, img);
  long long* __restrict__ const cursor0 = sc.cursor0;
  uint2* __restrict__ const entries = sc.entries;
  unsigned* __restrict__ const low = sc.low;
  int* so = smem;          // offsets [S + 1]
  int* se = smem + S + 1;  // steps through each slice [S]
  for (int j = threadIdx.x; j <= S; j += 32) so[j] = plan.off[j];
  for (int j = threadIdx.x; j < S; j += 32) se[j] = plan.ends[j];
  __syncwarp();
  const int W = gridDim.x, lane = threadIdx.x;
  const int l = blockIdx.x * 32 + lane;
  if (l == 0) *cursor0 = *cursor;
  const bool live = l < N;
  unsigned x = live ? (unsigned)states[l] : kRansL;
  int ds = 0, first, count, run = 0;
  unsigned ast[kAhead], afr[kAhead], bst[kAhead], bfr[kAhead];
  describe(so, se, S, N, lane, 0, ds, first, count);
  load_block(starts, freqs, first, count, l, ast, afr);
  uint2* ep = entries + (W - 1 - blockIdx.x) * padded_steps(G);
  unsigned* lp = low + l;
  for (long long g0 = 0; g0 < G; g0 += 2 * kAhead) {
    run_block(starts, freqs, so, se, S, N, l, lane, ds, g0, W, x, run, ast,
              afr, bst, bfr, ep + g0, lp + (g0 >> 1) * 32 * W);
    run_block(starts, freqs, so, se, S, N, l, lane, ds, g0 + kAhead, W, x,
              run, bst, bfr, ast, afr, ep + g0 + kAhead,
              lp + ((g0 + kAhead) >> 1) * 32 * W);
  }
  if (live) states[l] = (long long)x;
}

// Inclusive sum of v over the block (blockDim.x == kPlace).
__device__ __forceinline__ int block_scan(int v, int* warp_sums) {
  constexpr int kWarps = kPlace / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) before += k < warp ? warp_sums[k] : 0;
  return v + before;
}

// The words emitted through step g (all W warps' running counts there),
// summed by one warp.
__device__ __forceinline__ unsigned words_through(
    const uint2* __restrict__ entries, long long g, int W, long long Gp) {
  const int lane = threadIdx.x & 31;
  unsigned v = 0u;
  for (int w = lane; w < W; w += 32) v += entries[w * Gp + g].y;
  return __reduce_add_sync(kFull, v);
}

// The words of step g's first j_end entries in emission order, summed by
// one warp.
__device__ __forceinline__ unsigned words_in_step(
    const uint2* __restrict__ entries, long long g, int j_end, long long Gp) {
  const int lane = threadIdx.x & 31;
  unsigned v = 0u;
  for (int j = lane; j < j_end; j += 32) v += __popc(entries[j * Gp + g].x);
  return __reduce_add_sync(kFull, v);
}

// Entries a placement block takes: whole steps while a step's W entries
// fit in it (W <= kPlace), else kPlace entries, part of one step.
__host__ __device__ __forceinline__ long long place_entries(int W) {
  return W <= kPlace ? (long long)(kPlace / W) * W : kPlace;
}

__global__ void __launch_bounds__(kPlace)
    rans_encode_place_kernel(int* __restrict__ scratch,
                             const __grid_constant__ ChainPlan plan,
                             long long G, int N, int* __restrict__ cursor,
                             int* __restrict__ cursors,
                             int* __restrict__ buf, int cap) {
  __shared__ int warp_sums[kPlace / 32];
  const long long img = blockIdx.y;  // the image, as in the lanes kernel
  const Scratch sc = scratch_of(scratch, G, N, img);
  const uint2* __restrict__ entries = sc.entries;
  const unsigned* __restrict__ low = sc.low;
  const long long* __restrict__ cursor0 = sc.cursor0;
  cursor += img;
  cursors += img * plan.S;
  buf += img * cap;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = (N + 31) >> 5;
  const long long E = place_entries(W);
  const long long Gp = padded_steps(G);
  // the block's first entry, in emission order (e = g W + j: step g, the
  // j-th warp to emit in it, warp W - 1 - j)
  const long long e_lo = (long long)blockIdx.x * E;
  const long long g_lo = e_lo / W;
  const int j_lo = (int)(e_lo % W);
  const long long cur0 = *cursor0;
  const long long base =
      cur0 + (g_lo > 0 ? words_through(entries, g_lo - 1, W, Gp) : 0u) +
      (j_lo > 0 ? words_in_step(entries, g_lo, j_lo, Gp) : 0u);
  // thread tid holds entry e_lo + tid: step g, emitted by warp src
  const long long g = (e_lo + tid) / W;
  const int j = (int)((e_lo + tid) % W), src = W - 1 - j;
  const unsigned b = tid < E && g < G ? entries[j * Gp + g].x : 0u;
  const int incl = block_scan(__popc(b), warp_sums);
  // warp k places the words of its 32 entries, lane i those of lane i of
  // each: all 32 loads first, then the stores; entry jj's fields come
  // from lane jj
  unsigned word[32];
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const unsigned bj = __shfl_sync(kFull, b, jj);
    const long long gj = __shfl_sync(kFull, g, jj);
    const int sj = __shfl_sync(kFull, src, jj);
    word[jj] = ld_nc((const int*)low + ((gj >> 1) * W + sj) * 32 + lane,
                     (bj >> lane) & 1u) >> (16 * (gj & 1));
  }
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const unsigned bj = __shfl_sync(kFull, b, jj);
    // 2u << 31 wraps to 0, so lane 31 has no higher lanes in its warp
    const long long pos = base + __shfl_sync(kFull, incl, jj) - __popc(bj) +
                          __popc(bj & ~((2u << lane) - 1u));
    if (((bj >> lane) & 1u) && pos < cap) buf[pos] = (int)(word[jj] & 0xFFFFu);
  }
  // one warp per slice: the cursor after it, and after the chain
  const int S = plan.S, warps = kPlace / 32;
  for (int s = blockIdx.x * warps + warp; s <= S; s += gridDim.x * warps) {
    const long long end = s < S ? plan.ends[s] : G;
    const int v = (int)(cur0 + (end > 0 ? words_through(entries, end - 1, W,
                                                        Gp)
                                        : 0u));
    if (lane == 0) {
      if (s < S)
        cursors[s] = v;
      else
        *cursor = v;
    }
  }
}

}  // namespace

// Lanes per block of the decode: N / kCluster rounded up to whole warps
// (<= 1024 / 8).
static int decode_threads(int N) {
  return ((N + kCluster - 1) / kCluster + 31) & ~31;
}

// The wide decode's launch shape at N > kMaxLanes lanes: B threads a
// block, R lanes a thread.
struct WideShape {
  int B, R;
};

static WideShape wide_shape(int N) {
  constexpr long long most = (long long)kWideCluster * kWideThreads;
  const long long R = (N + most - 1) / most;  // lanes a thread
  const long long per = (N + kWideCluster * R - 1) / (kWideCluster * R);
  return {(int)((per + 31) & ~31LL), (int)R};
}

// The launch of the wide decode for K images (grid and block unset).
static cudaLaunchConfig_t wide_config(const WideShape& w, int K,
                                      cudaStream_t st,
                                      cudaLaunchAttribute* attr) {
  if (kWideCluster > 8)  // above the portable cluster size; a host call
    cudaFuncSetAttribute(rans_decode_wide_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kWideCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(kWideCluster * K));
  cfg.blockDim = dim3(w.B);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One slice of K images: cum [K, n, P], words rows of n_words valid words
// words_stride apart, states [K, N], offset [K], syms [K, n].
// N <= kMaxLanes runs rans_decode_kernel, above it rans_decode_wide_kernel.
// N above kMaxLaneCount is refused: lanes, symbols and word offsets are
// 32-bit ints in the kernels.
extern "C" int llicti_rans_decode(const int* cum, const int* words,
                                  long long n_words, long long words_stride,
                                  long long* states, int* offset, int* syms,
                                  int n, int P, int N, int K, void* stream) {
  if (N < 1 || N > kMaxLaneCount || P < 2 || K < 1 || K > (1 << 20) ||
      n_words < 0 || words_stride < n_words)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= kMaxLanes) {
    rans_decode_kernel<<<kCluster * K, decode_threads(N), 0, st>>>(
        cum, words, n_words, words_stride, states, offset, syms, n, P, N);
    return (int)cudaGetLastError();
  }
  const WideShape w = wide_shape(N);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(w, K, st, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, rans_decode_wide_kernel, cum, words, n_words,
                         words_stride, states, offset, syms, n, P, N, w.R);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Clusters of the decode at N lanes that the card holds at once; a batch
// of more images runs in waves.
extern "C" int llicti_rans_decode_max_clusters(int N, int* clusters) {
  if (N < 1 || N > kMaxLaneCount) return (int)cudaErrorInvalidValue;
  if (N <= kMaxLanes) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(decode_threads(N));
    // the cluster shape is the kernel's own (__cluster_dims__)
    return (int)cudaOccupancyMaxActiveClusters(clusters, rans_decode_kernel,
                                               &cfg);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(wide_shape(N), 1, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                             rans_decode_wide_kernel, &cfg);
}

// Scratch of K chains of G steps over N lanes, in int32 words.
extern "C" int llicti_rans_encode_scratch(long long G, int N, int K,
                                          long long* words) {
  *words = K * scratch_words(G, N);
  return 0;
}

// plan: int32 [2 S + 1] in host memory, the offsets [S + 1] of the S
// slices, then the chain's steps through each slice [S]; it reaches both
// kernels as a parameter.  G: the chain's steps.  K chains: starts and
// freqs [K, off[S]], states [K, N], cursor [K], buf [K, cap], cursors
// [K, S], scratch int32 [llicti_rans_encode_scratch(G, N, K)].  Launches
// nothing when G == 0.
extern "C" int llicti_rans_encode_chain(
    const int* starts, const int* freqs, const int* plan, int S, long long G,
    long long* states, int* cursor, int* buf, int cap, int* cursors,
    int* scratch, int N, int K, void* stream) {
  if (N < 1 || N > kMaxLaneCount || S < 1 || S > kMaxSlices || G < 0 ||
      K < 1 || K > 65535)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaGetLastError();
  ChainPlan p;
  p.S = S;
  for (int s = 0; s <= S; ++s) p.off[s] = plan[s];
  for (int s = 0; s < S; ++s) p.ends[s] = plan[S + 1 + s];
  const int W = (N + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  rans_encode_lanes_kernel<<<dim3(W, K), 32, (2 * S + 1) * sizeof(int),
                             st>>>(starts, freqs, p, G, states, cursor,
                                   scratch, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long E = place_entries(W);
  rans_encode_place_kernel<<<dim3((unsigned)((G * W + E - 1) / E), K), kPlace,
                             0, st>>>(scratch, p, G, N, cursor, cursors, buf,
                                      cap);
  return (int)cudaGetLastError();
}
