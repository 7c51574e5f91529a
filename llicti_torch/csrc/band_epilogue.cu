// The band epilogue: one pass over memory that finishes an interpolator
// conv's output.
//
// It replaces no TPU kernel.  XLA fuses a conv's bias add, the sum of
// layer 0's unit convs, the activation and the layout of the parameter map
// into the conv's output; PyTorch runs each as a pass of its own after
// cuDNN (which it never gives the bias).  This kernel does those passes in
// one: per element
//
//     y = act(((x0 + b0) + (x1 + b1)) + (x2 + b2))
//
// over U = 1..3 maps, each + its own float32 rounding in this order, as
// PyTorch's passes round them, so the output is bit-equal to theirs.  There
// is no multiply, so nothing can be contracted into an FMA.  A map given
// without a bias is taken as it is; act is none or ReLU with
// torch.clamp_min(y, 0)'s semantics (NaN stays NaN).
//
// It is bound by bytes: it reads each map once and writes the output once,
// 4 (U + 1) bytes an element.  The maps are [N, C, P] float32 with their P
// pixels at stride 1 and any image and channel strides.  The output is
// either of the same form (NCHW, a channel-major [C, N, P] view, or the
// first map itself: each element is read before its one write, by the
// same thread), read and written as float4 where every row is 16-byte
// aligned; or NHWC, [N, P, C] contiguous, staged through shared memory a
// tile of pixels x all C channels at a time, so that both the reads (a
// channel's pixels) and the writes (the tile's pixels' channels) are
// coalesced.
#include <cuda_runtime.h>

namespace llicti {

constexpr int kEpiThreads = 256;
constexpr int kEpiIlp = 4;           // loads in flight a thread
constexpr int kEpiMaxMaps = 3;
constexpr int kEpiSmemBytes = 48 * 1024;

struct EpilogueArgs {
  const float* x[kEpiMaxMaps];
  const float* b[kEpiMaxMaps];       // null: the map has no bias to add
  long long sn[kEpiMaxMaps], sc[kEpiMaxMaps];  // image, channel strides
  float* out;
  long long osn, osc;                // the output's, unless NHWC
  long long N, C, P;
};

template <int U, bool RELU>
__device__ __forceinline__ float finish(const float (&v)[U],
                                        const float (&bias)[U],
                                        unsigned has) {
  float s = (has & 1u) ? v[0] + bias[0] : v[0];
#pragma unroll
  for (int u = 1; u < U; ++u) {
    const float t = ((has >> u) & 1u) ? v[u] + bias[u] : v[u];
    s = s + t;
  }
  if (RELU) s = isnan(s) ? s : fmaxf(s, 0.f);  // at::clamp_min's CUDA op
  return s;
}

// The bias of channel c of each map, and which maps have one.
template <int U>
__device__ __forceinline__ unsigned load_bias(const EpilogueArgs& a,
                                              long long c, float (&bias)[U]) {
  unsigned has = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bias[u] = a.b[u] ? a.b[u][c] : 0.f;
    has |= a.b[u] ? 1u << u : 0u;
  }
  return has;
}

// [N, C, P] -> [N, C, P]: a (image, channel) row a blockIdx.y, its pixels
// over blockIdx.x; VEC: float4 along the pixels.
template <int U, bool RELU, bool VEC>
__global__ void __launch_bounds__(kEpiThreads)
    band_epilogue_kernel(EpilogueArgs a) {
  const long long rows = a.N * a.C;
  const long long width = VEC ? a.P / 4 : a.P;
  const long long stride = (long long)gridDim.x * kEpiThreads * kEpiIlp;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long n = row / a.C, c = row - n * a.C;
    float bias[U];
    const unsigned has = load_bias<U>(a, c, bias);
    const float* x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = a.x[u] + n * a.sn[u] + c * a.sc[u];
    float* o = a.out + n * a.osn + c * a.osc;
    for (long long i0 = (long long)blockIdx.x * kEpiThreads * kEpiIlp +
                        threadIdx.x;
         i0 < width; i0 += stride) {
      if (VEC) {
        float4 v[kEpiIlp][U];
#pragma unroll
        for (int k = 0; k < kEpiIlp; ++k) {
          const long long i = i0 + k * kEpiThreads;
          if (i < width) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              v[k][u] = reinterpret_cast<const float4*>(x[u])[i];
          }
        }
#pragma unroll
        for (int k = 0; k < kEpiIlp; ++k) {
          const long long i = i0 + k * kEpiThreads;
          if (i < width) {
            float e0[U], e1[U], e2[U], e3[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              e0[u] = v[k][u].x;
              e1[u] = v[k][u].y;
              e2[u] = v[k][u].z;
              e3[u] = v[k][u].w;
            }
            reinterpret_cast<float4*>(o)[i] = make_float4(
                finish<U, RELU>(e0, bias, has), finish<U, RELU>(e1, bias, has),
                finish<U, RELU>(e2, bias, has), finish<U, RELU>(e3, bias, has));
          }
        }
      } else {
        float v[kEpiIlp][U];
#pragma unroll
        for (int k = 0; k < kEpiIlp; ++k) {
          const long long i = i0 + k * kEpiThreads;
          if (i < width) {
#pragma unroll
            for (int u = 0; u < U; ++u) v[k][u] = x[u][i];
          }
        }
#pragma unroll
        for (int k = 0; k < kEpiIlp; ++k) {
          const long long i = i0 + k * kEpiThreads;
          if (i < width) o[i] = finish<U, RELU>(v[k], bias, has);
        }
      }
    }
  }
}

// [N, C, P] -> [N, P, C] contiguous, a tile of 2^log_tp pixels x C
// channels a block through shared memory ([C][tp + 1]: the writes' reads
// of one pixel's channels fall in distinct banks).  VEC: float4 reads.
template <int U, bool RELU, bool VEC>
__global__ void __launch_bounds__(kEpiThreads)
    band_epilogue_nhwc_kernel(EpilogueArgs a, int log_tp) {
  extern __shared__ float tile[];
  const int tp = 1 << log_tp, ld = tp + 1;
  const int C = (int)a.C;
  const long long per_image = (a.P + tp - 1) >> log_tp;
  const long long tiles = a.N * per_image;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long n = t / per_image;
    const long long p0 = (t - n * per_image) << log_tp;
    const int np = (int)min((long long)tp, a.P - p0);
    const float* x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = a.x[u] + n * a.sn[u] + p0;
    if (VEC) {  // np is a multiple of 4: P is, and so is p0
      const int qlog = log_tp - 2, nq = np >> 2;
      for (int j = threadIdx.x; j < (C << qlog); j += kEpiThreads) {
        const int c = j >> qlog, q = j & ((1 << qlog) - 1);
        if (q < nq) {
          float bias[U];
          const unsigned has = load_bias<U>(a, c, bias);
          float4 v[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            v[u] = reinterpret_cast<const float4*>(x[u] + c * a.sc[u])[q];
          float e0[U], e1[U], e2[U], e3[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            e0[u] = v[u].x;
            e1[u] = v[u].y;
            e2[u] = v[u].z;
            e3[u] = v[u].w;
          }
          float* row = tile + c * ld + 4 * q;
          row[0] = finish<U, RELU>(e0, bias, has);
          row[1] = finish<U, RELU>(e1, bias, has);
          row[2] = finish<U, RELU>(e2, bias, has);
          row[3] = finish<U, RELU>(e3, bias, has);
        }
      }
    } else {
      for (int j = threadIdx.x; j < (C << log_tp); j += kEpiThreads) {
        const int c = j >> log_tp, p = j & (tp - 1);
        if (p < np) {
          float bias[U];
          const unsigned has = load_bias<U>(a, c, bias);
          float v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) v[u] = x[u][c * a.sc[u] + p];
          tile[c * ld + p] = finish<U, RELU>(v, bias, has);
        }
      }
    }
    __syncthreads();
    float* o = a.out + (n * a.P + p0) * a.C;
    for (int j = threadIdx.x; j < np * C; j += kEpiThreads) {
      const int p = j / C, c = j - p * C;
      o[j] = tile[c * ld + p];
    }
    __syncthreads();
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

// Whether every map's rows (and, unless NHWC, the output's) start on 16
// bytes and hold a whole number of float4s.
template <int U>
bool vectorisable(const EpilogueArgs& a, bool nhwc) {
  if (a.P % 4) return false;
  for (int u = 0; u < U; ++u)
    if (!aligned16(a.x[u]) || a.sn[u] % 4 || a.sc[u] % 4) return false;
  return nhwc || (aligned16(a.out) && a.osn % 4 == 0 && a.osc % 4 == 0);
}

template <int U, bool RELU, bool VEC>
int launch(const EpilogueArgs& a, bool nhwc, cudaStream_t s) {
  if (nhwc) {
    int log_tp = 7;  // 128 pixels a tile, fewer where C is wide
    while (log_tp > 2 &&
           a.C * ((1 << log_tp) + 1) * (long long)sizeof(float) >
               kEpiSmemBytes)
      --log_tp;
    const long long smem = a.C * ((1 << log_tp) + 1) * sizeof(float);
    if (smem > kEpiSmemBytes) return (int)cudaErrorInvalidValue;
    const long long tiles = a.N * ((a.P + (1 << log_tp) - 1) >> log_tp);
    const unsigned grid = (unsigned)(tiles < (1 << 20) ? tiles : (1 << 20));
    band_epilogue_nhwc_kernel<U, RELU, VEC>
        <<<grid, kEpiThreads, (size_t)smem, s>>>(a, log_tp);
  } else {
    const long long width = VEC ? a.P / 4 : a.P;
    const long long per = (long long)kEpiThreads * kEpiIlp;
    const long long bx = (width + per - 1) / per;
    const long long rows = a.N * a.C;
    const dim3 grid((unsigned)(bx < (1 << 20) ? bx : (1 << 20)),
                    (unsigned)(rows < 65535 ? rows : 65535));
    band_epilogue_kernel<U, RELU, VEC><<<grid, kEpiThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int U>
int dispatch(const EpilogueArgs& a, bool relu, bool nhwc, cudaStream_t s) {
  const bool vec = vectorisable<U>(a, nhwc);
  if (relu)
    return vec ? launch<U, true, true>(a, nhwc, s)
               : launch<U, true, false>(a, nhwc, s);
  return vec ? launch<U, false, true>(a, nhwc, s)
             : launch<U, false, false>(a, nhwc, s);
}

}  // namespace llicti

// strides (host): each map's image and channel stride, then the output's
// (read unless nhwc); maps and biases beyond U are ignored.
extern "C" int llicti_band_epilogue(const float* x0, const float* x1,
                                    const float* x2, const float* b0,
                                    const float* b1, const float* b2,
                                    float* out, const long long* strides,
                                    int U, long long N, long long C,
                                    long long P, int relu, int nhwc,
                                    void* stream) {
  using namespace llicti;
  if (U < 1 || U > kEpiMaxMaps || N < 0 || C < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || C == 0 || P == 0) return (int)cudaGetLastError();
  EpilogueArgs a{{x0, x1, x2},
                 {b0, b1, b2},
                 {strides[0], strides[2], strides[4]},
                 {strides[1], strides[3], strides[5]},
                 out,
                 strides[6],
                 strides[7],
                 N,
                 C,
                 P};
  cudaStream_t s = (cudaStream_t)stream;
  switch (U) {
    case 1: return dispatch<1>(a, relu != 0, nhwc != 0, s);
    case 2: return dispatch<2>(a, relu != 0, nhwc != 0, s);
    default: return dispatch<3>(a, relu != 0, nhwc != 0, s);
  }
}
