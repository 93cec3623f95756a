// GroupNorm + optional SiLU, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel weatherforecastingtoolkit_tpu/ops/pallas/groupnorm.py
// `_gn_silu_kernel` (launched by `_gn_silu_forward`). It computes the same
// function: per (sample, group) fp32 mean and variance, normalise, per-channel
// fp32 affine, optional SiLU, and one cast back to the input dtype.
//
// Bound: device-memory bytes. The function reads x once and writes y once and
// does about ten flops per element, far below what the card can do per byte.
//
// Design. The TPU kernel keeps one whole (H, W, C) frame in VMEM per grid step.
// On Hopper a (128, 128, 128) fp32 frame is 8 MB against 227 KB of shared
// memory per SM, and the streaming tick has N = 1, so one block per sample
// would leave most of the 132 SMs idle. Three launches instead:
//   1. stats: blocks over (sample[, group], chunk of positions) reduce their
//      chunk to partial (count, mean, M2) in fp32 (Welford per thread, Chan's
//      merge across threads) and write it to scratch;
//   2. combine: one thread per (sample, group) merges its chunks in a fixed
//      order with Chan's formula and stores mean and 1/sqrt(var + eps);
//   3. apply: a grid-stride elementwise pass with 16-byte vector accesses.
// No float atomics, so a result is the same from run to run. The variance is
// never formed as E[x^2] - mean^2, which cancels in fp32 at 262,144 elements a
// group. x is read twice (stats, apply): 1.5x the bytes of the bound.
//
// Layouts: contiguous NCHW, where a (sample, group) is one contiguous run of
// (C/G)*H*W elements, and channels_last (NHWC), where a block reads all C
// channels of a run of positions so that a warp reads consecutive addresses.
//
// Entry point: gn_silu_forward (plain C, loaded with ctypes). It launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct F32 {
  using S = float;
  static __device__ __forceinline__ float load(S v) { return v; }
  static __device__ __forceinline__ S store(float v) { return v; }
};

struct BF16 {
  using S = unsigned short;  // raw bf16 bits
  static __device__ __forceinline__ float load(S v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ S store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S v[VEC];
};

// Count, mean and sum of squared deviations of a set of values.
struct Stats {
  float n, mean, m2;
};

// Chan et al.: the statistics of the union of two disjoint sets.
__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float delta = b.mean - a.mean;
  Stats r;
  r.n = n;
  r.mean = a.mean + delta * wb;
  r.m2 = a.m2 + b.m2 + delta * delta * a.n * wb;
  return r;
}

// Tree over the lanes in a fixed order; lane 0 ends with the warp's total.
__device__ __forceinline__ Stats warp_merge(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.n = __shfl_down_sync(0xffffffffu, s.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, s.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, s.m2, off);
    s = merge(s, o);
  }
  return s;
}

// blockDim.x a multiple of 32; thread 0 ends with the block's total.
__device__ __forceinline__ Stats block_merge(Stats s) {
  __shared__ Stats warps[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s = warp_merge(s);
  if (lane == 0) warps[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const Stats zero = {0.f, 0.f, 0.f};
    s = lane < static_cast<int>(blockDim.x >> 5) ? warps[lane] : zero;
    s = warp_merge(s);
  }
  return s;
}

constexpr int kStatsThreads = 256;

// NCHW: x is (N*G) rows of L = (C/G)*H*W contiguous elements, L % VEC == 0.
// grid (N*G, chunks). part[row * chunks + chunk].
template <typename T, int VEC>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_rows(const typename T::S* __restrict__ x, Stats* __restrict__ part,
              int64_t L) {
  using P = Pack<typename T::S, VEC>;
  const int64_t row = blockIdx.x;
  const int chunks = gridDim.y;
  const int64_t nv = L / VEC;
  const int64_t per = (nv + chunks - 1) / chunks;
  const int64_t v0 = blockIdx.y * per;
  const int64_t v1 = v0 + per < nv ? v0 + per : nv;
  const P* xv = reinterpret_cast<const P*>(x + row * L);
  Stats s = {0.f, 0.f, 0.f};
  for (int64_t i = v0 + threadIdx.x; i < v1; i += blockDim.x) {
    const P p = xv[i];
    float f[VEC];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      f[j] = T::load(p.v[j]);
      sum += f[j];
    }
    const float mean = sum * (1.f / VEC);
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = f[j] - mean;
      m2 += d * d;
    }
    const Stats v = {static_cast<float>(VEC), mean, m2};
    s = merge(s, v);
  }
  s = block_merge(s);
  if (threadIdx.x == 0) part[row * chunks + blockIdx.y] = s;
}

// channels_last: sample n is an (H*W, C) matrix, C % VEC == 0. A block takes
// a chunk of positions and all C channels: thread t owns channels
// [c0, c0 + VEC) of rows r, r + rows, ... with tpr = C / VEC threads a row.
// grid (N, chunks), blockDim = rows * tpr. Dynamic shared memory:
// (2 * rows * C + rows) floats. part[(n * G + g) * chunks + chunk].
template <typename T, int VEC>
__global__ void gn_stats_cl(const typename T::S* __restrict__ x,
                            Stats* __restrict__ part, int64_t hw, int C,
                            int G) {
  using P = Pack<typename T::S, VEC>;
  extern __shared__ float smem[];
  const int tpr = C / VEC;
  const int rows = blockDim.x / tpr;
  const int t = threadIdx.x;
  const int r = t / tpr;
  const int c0 = (t % tpr) * VEC;
  const int64_t n = blockIdx.x;
  const int chunks = gridDim.y;
  const int64_t per = (hw + chunks - 1) / chunks;
  const int64_t p0 = blockIdx.y * per;
  const int64_t p1 = p0 + per < hw ? p0 + per : hw;
  float mean[VEC], m2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) mean[j] = m2[j] = 0.f;
  float cnt = 0.f;
  for (int64_t p = p0 + r; p < p1; p += rows) {
    const P pk = *reinterpret_cast<const P*>(x + (n * hw + p) * C + c0);
    cnt += 1.f;
    const float inv = 1.f / cnt;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = T::load(pk.v[j]);
      const float d = v - mean[j];
      mean[j] += d * inv;
      m2[j] += d * (v - mean[j]);
    }
  }
  float* sm_mean = smem;
  float* sm_m2 = smem + rows * C;
  float* sm_n = smem + 2 * rows * C;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sm_mean[r * C + c0 + j] = mean[j];
    sm_m2[r * C + c0 + j] = m2[j];
  }
  if (t % tpr == 0) sm_n[r] = cnt;
  __syncthreads();
  const int cg = C / G;
  for (int g = t; g < G; g += blockDim.x) {
    Stats s = {0.f, 0.f, 0.f};
    for (int rr = 0; rr < rows; ++rr) {
      for (int c = g * cg; c < (g + 1) * cg; ++c) {
        const Stats v = {sm_n[rr], sm_mean[rr * C + c], sm_m2[rr * C + c]};
        s = merge(s, v);
      }
    }
    part[(n * G + g) * chunks + blockIdx.y] = s;
  }
}

// One thread per (sample, group): merge its chunks in order.
__global__ void gn_combine(const Stats* __restrict__ part,
                           float2* __restrict__ mean_rstd, int64_t rows,
                           int chunks, float eps) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= rows) return;
  Stats s = {0.f, 0.f, 0.f};
  for (int k = 0; k < chunks; ++k) s = merge(s, part[i * chunks + k]);
  const float var = s.m2 / s.n;  // population variance, as the reference
  mean_rstd[i] = make_float2(s.mean, 1.f / sqrtf(var + eps));
}

__device__ __forceinline__ float finish(float v, float2 mr, float a, float b,
                                        bool silu) {
  float y = (v - mr.x) * mr.y;
  y = y * a + b;
  if (silu) y = y / (1.f + expf(-y));
  return y;
}

// y = finish(x); NCHW needs H*W % VEC == 0 (a vector stays in one channel),
// channels_last needs C % VEC == 0.
template <typename T, int VEC, bool CL>
__global__ void gn_apply(const typename T::S* __restrict__ x,
                         typename T::S* __restrict__ y,
                         const float2* __restrict__ mean_rstd,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, int64_t total,
                         int64_t hw, int C, int G, int silu) {
  using P = Pack<typename T::S, VEC>;
  const int cg = C / G;
  const int64_t nvec = total / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < nvec; i += stride) {
    const int64_t e = i * VEC;
    const P in = reinterpret_cast<const P*>(x)[i];
    P out;
    if (CL) {
      const int c0 = static_cast<int>(e % C);
      const int64_t n = e / (hw * C);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = c0 + j;
        out.v[j] = T::store(finish(T::load(in.v[j]), mean_rstd[n * G + c / cg],
                                   scale[c], bias[c], silu));
      }
    } else {
      const int64_t nc = e / hw;
      const int c = static_cast<int>(nc % C);
      const int64_t n = nc / C;
      const float2 mr = mean_rstd[n * G + c / cg];
      const float a = scale[c];
      const float b = bias[c];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = T::store(finish(T::load(in.v[j]), mr, a, b, silu));
    }
    reinterpret_cast<P*>(y)[i] = out;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, const float* scale,
                   const float* bias, void* part, void* mean_rstd, int64_t n,
                   int c, int64_t hw, int groups, float eps, int silu,
                   int channels_last, int chunks, cudaStream_t stream) {
  using S = typename T::S;
  const S* xs = static_cast<const S*>(x);
  Stats* ps = static_cast<Stats*>(part);
  float2* mr = static_cast<float2*>(mean_rstd);
  const int64_t rows = n * groups;
  if (channels_last) {
    const int tpr = c / VEC;
    const int per_block = tpr >= 256 ? 1 : 256 / tpr;
    const int threads = per_block * tpr;
    const size_t smem = (2 * static_cast<size_t>(per_block) * c + per_block) *
                        sizeof(float);
    gn_stats_cl<T, VEC><<<dim3(static_cast<unsigned>(n), chunks), threads,
                          smem, stream>>>(xs, ps, hw, c, groups);
  } else {
    gn_stats_rows<T, VEC><<<dim3(static_cast<unsigned>(rows), chunks),
                            kStatsThreads, 0, stream>>>(
        xs, ps, static_cast<int64_t>(c / groups) * hw);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_combine<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(
      ps, mr, rows, chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = n * c * hw;
  const int64_t nvec = total / VEC;
  int64_t blocks = (nvec + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (channels_last)
    gn_apply<T, VEC, true><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        xs, static_cast<S*>(y), mr, scale, bias, total, hw, c, groups, silu);
  else
    gn_apply<T, VEC, false><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        xs, static_cast<S*>(y), mr, scale, bias, total, hw, c, groups, silu);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, C, H, W) of one dtype, both contiguous NCHW or both channels_last.
// scale, bias: (C,) fp32. part: N*G*chunks*3 fp32. mean_rstd: N*G*2 fp32.
// is_bf16: 0 for fp32, 1 for bf16. vec: 1, or 16 bytes' worth of elements
// (4 fp32, 8 bf16) when the layout allows it (see gn_apply).
extern "C" int gn_silu_forward(const void* x, void* y, const float* scale,
                               const float* bias, void* part, void* mean_rstd,
                               long long n, long long c, long long hw,
                               int groups, float eps, int silu,
                               int channels_last, int is_bf16, int vec,
                               int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ci = static_cast<int>(c);
  if (is_bf16) {
    if (vec == 8)
      return launch<BF16, 8>(x, y, scale, bias, part, mean_rstd, n, ci, hw,
                             groups, eps, silu, channels_last, chunks, st);
    if (vec == 1)
      return launch<BF16, 1>(x, y, scale, bias, part, mean_rstd, n, ci, hw,
                             groups, eps, silu, channels_last, chunks, st);
  } else {
    if (vec == 4)
      return launch<F32, 4>(x, y, scale, bias, part, mean_rstd, n, ci, hw,
                            groups, eps, silu, channels_last, chunks, st);
    if (vec == 1)
      return launch<F32, 1>(x, y, scale, bias, part, mean_rstd, n, ci, hw,
                            groups, eps, silu, channels_last, chunks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
