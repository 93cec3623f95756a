// Conv bias epilogue for Hopper (sm_90a): y = (h + b_h [+ r + b_r]) / f.
//
// Replaces no TPU kernel. XLA fuses a conv's bias add, and a resnet block's
// residual add, into the conv's own output pass; cuDNN as PyTorch calls it
// does not: ATen adds the bias in a second pass, an unvectorised broadcast
// over channels_last (elementwise_kernel<128, 4>), and the residual add in a
// third. The port runs its native convs without bias and this kernel adds
// the bias, and in a resnet block the shortcut's bias and the residual,
// in one pass: fp32 arithmetic in the order written above (fp64 for fp64),
// one rounding to the tensor's dtype (fp32, bf16, fp16 or fp64; f is read as
// fp32 in every dtype). The bias-only case therefore
// gives ATen's h + b bit for bit (ATen also adds in fp32 and rounds once).
//
// Bound: device-memory bytes. Per element it reads h (and r) once and writes
// y once, with two or three adds and at most one division: at 3.35 TB/s a
// bf16 bias pass over 16.8 M elements is 20 us. Design:
//   * every thread moves 16 bytes a load and a store, neighbouring threads
//     neighbouring addresses, two vectors in flight a thread and iteration;
//   * channels_last (the main path): the channel of element i is i % C, so
//     the channels of vector v repeat with a period of C / gcd(C, V)
//     vectors (V elements a vector). A grid-stride loop whose stride is a
//     multiple of that period gives each thread a fixed set of channels:
//     their biases are read once into registers, and the loop does no
//     division, modulo or gather. Any C works (C = 1 and C = 16 included);
//     the elements after the last whole vector take a scalar tail;
//   * contiguous NCHW: a block takes whole (sample, channel) planes, reads
//     the plane's two biases once and streams the plane in vectors when
//     H*W is a multiple of V (scalar loads otherwise);
//   * pointers not 16-byte aligned take the same kernels at V = 1.
// The grid (a multiple of the SMs, from the wrapper, ops/cuda/
// conv_epilogue.py::_plan) holds as many blocks as stay resident.
//
// Entry point (plain C, loaded with ctypes): conv_epilogue_forward launches
// on the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct F32 {
  using S = float;
  using A = float;
  static __device__ __forceinline__ float load(S v) { return v; }
  static __device__ __forceinline__ S store(float v) { return v; }
};

struct F64 {  // float64 adds in float64
  using S = double;
  using A = double;
  static __device__ __forceinline__ double load(S v) { return v; }
  static __device__ __forceinline__ S store(double v) { return v; }
};

struct BF16 {
  using S = unsigned short;  // raw bf16 bits
  using A = float;
  static __device__ __forceinline__ float load(S v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ S store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct F16 {
  using S = unsigned short;  // raw fp16 bits
  using A = float;
  static __device__ __forceinline__ float load(S v) {
    return __half2float(__ushort_as_half(v));
  }
  static __device__ __forceinline__ S store(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <typename S, int V>
struct alignas(sizeof(S) * V) Pack {
  S v[V];
};

constexpr int kThreads = 256;
constexpr int kBytes[4] = {4, 2, 2, 8};  // element bytes by dtype code

// What one element gets: ((h + bh) + (r + br)) / f, each add only where its
// operand exists (h + 0 would turn -0 into +0), in fp32 (fp64 for fp64).
template <bool RES, typename A>
__device__ __forceinline__ A combine(A h, A bh, bool has_bh, A r, A br,
                                     bool has_br, A f, bool div) {
  A v = has_bh ? h + bh : h;
  if (RES) v = v + (has_br ? r + br : r);
  return div ? v / f : v;
}

__device__ __forceinline__ int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// channels_last (N, H, W, C) as one flat run of n elements; nvec whole
// vectors of V, then the tail.
template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kThreads)
epi_channels_last(const typename T::S* __restrict__ h,
                  const typename T::S* __restrict__ bh,
                  const typename T::S* __restrict__ r,
                  const typename T::S* __restrict__ br,
                  typename T::S* __restrict__ y, long long nvec, long long n,
                  int c, float f) {
  using P = Pack<typename T::S, V>;
  using A = typename T::A;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const bool has_bh = bh != nullptr, has_br = RES && br != nullptr;
  const bool div = f != 1.0;
  const long long tail0 = nvec * V;
  if (t < n - tail0) {
    const long long e = tail0 + t;
    const int ch = static_cast<int>(e % c);
    y[e] = T::store(combine<RES, A>(
        T::load(h[e]), has_bh ? T::load(bh[ch]) : A(0), has_bh,
        RES ? T::load(r[e]) : A(0), has_br ? T::load(br[ch]) : A(0), has_br,
        f, div));
  }
  const int period = c / gcd(c, V);
  const long long total = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long stride = total / period * period;
  if (t >= stride) return;
  const int col = static_cast<int>(t % period);
  A b1[V], b2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = (col * V + j) % c;
    b1[j] = has_bh ? T::load(bh[ch]) : A(0);
    b2[j] = has_br ? T::load(br[ch]) : A(0);
  }
  const P* hv = reinterpret_cast<const P*>(h);
  const P* rv = reinterpret_cast<const P*>(r);
  P* yv = reinterpret_cast<P*>(y);
  for (long long v = t; v < nvec; v += 2 * stride) {
    const long long v2 = v + stride;
    const bool two = v2 < nvec;
    P a = hv[v], a2, ra, ra2;
    if (RES) ra = rv[v];
    if (two) {
      a2 = hv[v2];
      if (RES) ra2 = rv[v2];
    }
    P o;
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.v[j] = T::store(combine<RES, A>(T::load(a.v[j]), b1[j], has_bh,
                                     RES ? T::load(ra.v[j]) : A(0), b2[j],
                                     has_br, f, div));
    yv[v] = o;
    if (two) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = T::store(combine<RES, A>(T::load(a2.v[j]), b1[j], has_bh,
                                       RES ? T::load(ra2.v[j]) : A(0), b2[j],
                                       has_br, f, div));
      yv[v2] = o;
    }
  }
}

// contiguous NCHW: `planes` (sample, channel) planes of `len` vectors of V.
template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kThreads)
epi_nchw(const typename T::S* __restrict__ h,
         const typename T::S* __restrict__ bh,
         const typename T::S* __restrict__ r,
         const typename T::S* __restrict__ br, typename T::S* __restrict__ y,
         long long planes, long long len, int c, float f) {
  using P = Pack<typename T::S, V>;
  using A = typename T::A;
  const bool has_bh = bh != nullptr, has_br = RES && br != nullptr;
  const bool div = f != 1.0;
  for (long long p = blockIdx.x; p < planes; p += gridDim.x) {
    const int ch = static_cast<int>(p % c);
    const A b1 = has_bh ? T::load(bh[ch]) : A(0);
    const A b2 = has_br ? T::load(br[ch]) : A(0);
    const P* hv = reinterpret_cast<const P*>(h) + p * len;
    const P* rv = reinterpret_cast<const P*>(r) + (RES ? p * len : 0);
    P* yv = reinterpret_cast<P*>(y) + p * len;
    for (long long j = threadIdx.x; j < len; j += blockDim.x) {
      const P a = hv[j];
      P ra;
      if (RES) ra = rv[j];
      P o;
#pragma unroll
      for (int k = 0; k < V; ++k)
        o.v[k] = T::store(combine<RES, A>(T::load(a.v[k]), b1, has_bh,
                                       RES ? T::load(ra.v[k]) : A(0), b2,
                                       has_br, f, div));
      yv[j] = o;
    }
  }
}

template <typename T, int V, bool RES>
cudaError_t launch_v(const void* h, const void* bh, const void* r,
                     const void* br, void* y, long long n, int c,
                     long long hw, int channels_last, float f, int grid,
                     int threads, cudaStream_t s) {
  using S = typename T::S;
  const S* hp = static_cast<const S*>(h);
  const S* bhp = static_cast<const S*>(bh);
  const S* rp = static_cast<const S*>(r);
  const S* brp = static_cast<const S*>(br);
  S* yp = static_cast<S*>(y);
  if (channels_last)
    epi_channels_last<T, V, RES><<<grid, threads, 0, s>>>(
        hp, bhp, rp, brp, yp, n / V, n, c, f);
  else
    epi_nchw<T, V, RES><<<grid, threads, 0, s>>>(hp, bhp, rp, brp, yp, n / hw,
                                                 hw / V, c, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* h, const void* bh, const void* r,
                   const void* br, void* y, long long n, int c, long long hw,
                   int channels_last, int vec, float f, int grid, int threads,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(typename T::S);
  if (vec == V)
    return r ? launch_v<T, V, true>(h, bh, r, br, y, n, c, hw, channels_last,
                                    f, grid, threads, s)
             : launch_v<T, V, false>(h, bh, r, br, y, n, c, hw, channels_last,
                                     f, grid, threads, s);
  return r ? launch_v<T, 1, true>(h, bh, r, br, y, n, c, hw, channels_last, f,
                                  grid, threads, s)
           : launch_v<T, 1, false>(h, bh, r, br, y, n, c, hw, channels_last, f,
                                   grid, threads, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16, 3 fp64. vec: 16 / element bytes, or 1 for
// scalar loads. h, r and y hold n elements of (N, C, H, W) with hw = H*W, in
// channels_last order or contiguous NCHW; bh and br are (C,) in h's dtype;
// r, bh and br may be null.
extern "C" int conv_epilogue_forward(const void* h, const void* bh,
                                     const void* r, const void* br, void* y,
                                     long long n, int c, long long hw,
                                     int channels_last, int dtype, int vec,
                                     float f, int grid, int threads,
                                     void* stream) {
  if (n <= 0 || c < 1 || hw < 1 || grid < 1 || threads < 1 ||
      threads > kThreads || threads % 32 || dtype < 0 || dtype > 3 ||
      (vec != 1 && vec * kBytes[dtype] != 16) ||
      (!channels_last && hw % vec))
    return static_cast<int>(cudaErrorInvalidValue);
  // channels_last: the grid must hold one period of channel vectors
  int a = c, b = vec;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  if (channels_last && static_cast<long long>(grid) * threads < c / a)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<F32>(h, bh, r, br, y, n, c, hw,
                                          channels_last, vec, f, grid,
                                          threads, s));
    case 1:
      return static_cast<int>(launch<BF16>(h, bh, r, br, y, n, c, hw,
                                           channels_last, vec, f, grid,
                                           threads, s));
    case 3:
      return static_cast<int>(launch<F64>(h, bh, r, br, y, n, c, hw,
                                          channels_last, vec, f, grid,
                                          threads, s));
    default:
      return static_cast<int>(launch<F16>(h, bh, r, br, y, n, c, hw,
                                          channels_last, vec, f, grid,
                                          threads, s));
  }
}
