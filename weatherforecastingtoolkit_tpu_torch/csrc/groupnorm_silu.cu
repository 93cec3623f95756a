// GroupNorm + optional SiLU, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel weatherforecastingtoolkit_tpu/ops/pallas/groupnorm.py
// `_gn_silu_kernel` (launched by `_gn_silu_forward`). It computes the same
// function: per (sample, group) fp32 mean and population variance,
// normalise, per-channel fp32 affine, optional SiLU, and one cast back to the
// input dtype. scale and bias are read in their own dtype (fp32 or bf16;
// bf16 -> fp32 is exact, as the JAX `scale.astype(f32)`).
//
// Bound: device-memory bytes. The function must read x once and write y once
// and does about ten flops per element, far below what the card can do per
// byte. What kept the first design (three launches: statistics, combine,
// apply) from that bound: x was read twice, the apply loop spent 64-bit
// divisions, an integer division and three gathers per element, and the
// bf16 path added two launches to cast scale and bias.
//
// Design (gn_cluster, one launch per call). The unit of work is a slab: one
// sample times a run of k consecutive whole groups. In channels_last a slab
// is H*W positions times a run of k*C/G channels of 32 to 256 bytes, so
// every position's run is whole 16-byte vectors on a 16-byte boundary; the
// plan takes the widest run whose slab fits a cluster of 64 KB blocks
// (wider runs use DRAM better; 64 KB leaves room for three blocks an SM).
// One thread-block cluster (`cudaLaunchKernelEx` with a cluster dimension;
// 8 is portable, 16 after cudaFuncAttributeNonPortableClusterSizeAllowed,
// which the 128x128 frames use) holds one slab in its blocks' shared
// memory, each block a share of the positions:
//   1. load the share with cp.async, every 16-byte load of a thread in
//      flight at once, in four groups so that the first pass sums each group
//      as it lands (a thread reads back only what it loaded): x is read from
//      device memory once;
//   2. per group, the block's mean, then the sum of squared deviations from
//      it, both over shared memory (never E[x^2] - mean^2, which cancels in
//      fp32 at 262,144 elements a group), as a partial (count, mean, M2);
//   3. cluster barrier;
//   4. every block reads all peers' partials through distributed shared
//      memory and merges them in rank order with Chan's formula: no float
//      atomics, the same bits every run and in every block;
//   5. each thread owns a fixed 16-byte vector of the run's channels, folds
//      rstd * scale into one factor a per channel before the loop and
//      computes y = (x - mean) * a + bias from shared memory (the subtraction
//      first, so a large mean does not cancel), SiLU with __expf and a fast
//      division, and writes y with 16-byte stores;
//   6. a last cluster barrier, so that no block exits while a peer still
//      reads its shared memory (arrive after the reads of step 4, wait at the
//      end).
// The plan (k, cluster size, positions per block) is made in Python
// (`ops/cuda/groupnorm.py::_plan`), so the CPU tests check it at every call
// shape of the serving path.
//
// Two-pass path (gn_stats_* + gn_combine + gn_apply_*; three launches and
// scratch for the statistics), for what a cluster cannot take: NCHW input,
// C not a multiple of the 16-byte vector, x or y not 16-byte aligned, a
// group whose bytes divide no run of 32 to 256 bytes, or a slab over 16
// blocks' shared memory (H*W above about 112k positions, 335x335, at a
// 32-byte run). No call of the serving paths takes it. Its apply loops do no integer division and no gather: a block
// owns one (sample, channel) row (NCHW) or a fixed set of channel vectors
// (channels_last), and computes mean, a and bias once.
//
// Entry points (plain C, loaded with ctypes): gn_silu_forward launches on the
// caller's stream, allocates nothing and returns cudaGetLastError();
// gn_silu_device_limits reports the shared memory a block can opt into and
// the largest cluster the cluster kernel schedules with it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ float finish(float v, float mean, float a, float b,
                                        bool silu) {
  const float y = (v - mean) * a + b;
  return silu ? __fdividef(y, 1.f + __expf(-y)) : y;
}

// ------------------------------------------------------ the cluster kernel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRunChannels = 128;  // a run is at most 256 bytes
constexpr int kMaxSlabGroups = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` (0..3) copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Sum acc over the lanes that own the same vector (lane % tpp), then lanes
// 0..tpp-1 write the warp's per-channel sums to red[warp][run channel].
template <int VEC>
__device__ __forceinline__ void warp_channel_sums(float (&acc)[VEC], int tpp,
                                                  float (*red)[kMaxRunChannels]) {
  for (int off = 16; off >= tpp; off >>= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  const int lane = threadIdx.x & 31;
  if (lane < tpp) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[threadIdx.x >> 5][lane * VEC + j] = acc[j];
  }
}

// Per-group sums of the values warp_channel_sums left in red, in a fixed
// order: threads t < run sum channel t over the warps into chan, then
// threads t < k sum group t's channels. Ends with the sums in threads < k.
__device__ __forceinline__ float group_sums(const float (*red)[kMaxRunChannels],
                                            float* chan, int run, int k,
                                            int cpg) {
  const int t = threadIdx.x;
  __syncthreads();
  if (t < run) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][t];
    chan[t] = s;
  }
  __syncthreads();
  float s = 0.f;
  if (t < k)
    for (int c = t * cpg; c < (t + 1) * cpg; ++c) s += chan[c];
  return s;
}

// grid: n * slabs * cs blocks in clusters of cs; block b of a cluster is
// rank b % cs of slab b / cs = sample * slabs + s. Dynamic shared memory:
// ppb positions * run bytes. k groups of cpg channels a slab, run = k*cpg
// channels = tpp vectors of VEC, tpp a power of two <= 16.
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_cluster(const typename T::S* __restrict__ x, typename T::S* __restrict__ y,
           const typename P::S* __restrict__ scale,
           const typename P::S* __restrict__ bias, int hw, int C, int cpg,
           int k, int ppb, int slabs, float eps, int silu) {
  using V = Pack<typename T::S, VEC>;
  extern __shared__ __align__(16) unsigned char tile_raw[];
  __shared__ float red[kWarps][kMaxRunChannels];
  __shared__ float chan[kMaxRunChannels];
  __shared__ Stats part[kMaxSlabGroups];      // read by the peers
  __shared__ float2 final_stats[kMaxSlabGroups];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t slab_id = blockIdx.x / cs;
  const int s = static_cast<int>(slab_id % slabs);
  const int64_t n = slab_id / slabs;
  const int run = k * cpg;
  const int tpp = run / VEC;
  const int t = threadIdx.x;
  const int v = t & (tpp - 1);
  const int p0 = t / tpp;                  // tpp is a power of two
  const int pstep = kThreads / tpp;
  const int first = rank * ppb;
  const int count = max(0, min(ppb, hw - first));
  // the thread's positions p0 + i * pstep, i < mine; its vector of position
  // p0 + i * pstep is tile[t + i * kThreads], which only it reads and writes
  const int mine = count > p0 ? (count - p0 + pstep - 1) / pstep : 0;
  const int64_t offset = (n * hw + first + p0) * C + s * run + v * VEC;
  const int64_t gstep = static_cast<int64_t>(pstep) * C;
  V* tile = reinterpret_cast<V*>(tile_raw) + t;

  // 1. the block's share of the slab into shared memory, every load in
  //    flight, in kStages groups; 2a. the sums per channel as they land
  constexpr int kStages = 4;
  const int per_stage = (mine + kStages - 1) / kStages;
  {
    const typename T::S* src = x + offset;
    int i = 0;
    for (int st = 0; st < kStages; ++st) {
      for (const int end = min(mine, (st + 1) * per_stage); i < end;
           ++i, src += gstep)
        cp_async16(tile + i * kThreads, src);
      cp_async_commit();
    }
  }
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  {
    int i = 0;
    for (int st = 0; st < kStages; ++st) {
      cp_async_wait_pending(kStages - 1 - st);
      for (const int end = min(mine, (st + 1) * per_stage); i < end; ++i) {
        const V pk = tile[i * kThreads];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += T::load(pk.v[j]);
      }
    }
  }

  // 2. per group: the block's mean, then M2 about it
  warp_channel_sums<VEC>(acc, tpp, red);
  const float cnt = static_cast<float>(count) * cpg;
  {
    const float sum = group_sums(red, chan, run, k, cpg);
    if (t < k) {
      part[t].n = cnt;
      part[t].mean = cnt > 0.f ? sum / cnt : 0.f;
    }
  }
  __syncthreads();
  float mean[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mean[j] = part[(v * VEC + j) / cpg].mean;
    acc[j] = 0.f;
  }
  for (int i = 0; i < mine; ++i) {
    const V pk = tile[i * kThreads];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = T::load(pk.v[j]) - mean[j];
      acc[j] += d * d;
    }
  }
  warp_channel_sums<VEC>(acc, tpp, red);
  {
    const float m2 = group_sums(red, chan, run, k, cpg);
    if (t < k) part[t].m2 = m2;
  }

  // 3.-4. merge every block's partial in rank order (distributed shared mem)
  cluster.sync();
  if (t < k) {
    Stats a = {0.f, 0.f, 0.f};
    for (int r = 0; r < cs; ++r) a = merge(a, cluster.map_shared_rank(part, r)[t]);
    const float var = a.m2 / a.n;  // population variance, as the reference
    final_stats[t] = make_float2(a.mean, 1.f / sqrtf(var + eps));
  }
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  __syncthreads();

  // 5. apply from shared memory: per channel mean, a = rstd * scale, bias
  float a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = v * VEC + j;
    const float2 st = final_stats[c / cpg];
    mean[j] = st.x;
    a[j] = st.y * P::load(scale[s * run + c]);
    b[j] = P::load(bias[s * run + c]);
  }
  {
    typename T::S* dst = y + offset;
    const bool act = silu != 0;
    for (int i = 0; i < mine; ++i, dst += gstep) {
      const V pk = tile[i * kThreads];
      V out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = T::store(finish(T::load(pk.v[j]), mean[j], a[j], b[j], act));
      *reinterpret_cast<V*>(dst) = out;
    }
  }
  // 6. peers may still be reading `part`
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ------------------------------------------------------- two-pass path
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

constexpr int kRowThreads = 256;

// NCHW: x is (N*G) rows of L = (C/G)*H*W contiguous elements, L % VEC == 0.
// grid (N*G, chunks). part[row * chunks + chunk].
template <typename T, int VEC>
__global__ void __launch_bounds__(kRowThreads)
gn_stats_rows(const typename T::S* __restrict__ x, Stats* __restrict__ part,
              int64_t L) {
  using V = Pack<typename T::S, VEC>;
  const int64_t row = blockIdx.x;
  const int chunks = gridDim.y;
  const int64_t nv = L / VEC;
  const int64_t per = (nv + chunks - 1) / chunks;
  const int64_t v0 = blockIdx.y * per;
  const int64_t v1 = v0 + per < nv ? v0 + per : nv;
  const V* xv = reinterpret_cast<const V*>(x + row * L);
  Stats s = {0.f, 0.f, 0.f};
  for (int64_t i = v0 + threadIdx.x; i < v1; i += blockDim.x) {
    const V p = xv[i];
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
    const Stats val = {static_cast<float>(VEC), mean, m2};
    s = merge(s, val);
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
  using V = Pack<typename T::S, VEC>;
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
    const V pk = *reinterpret_cast<const V*>(x + (n * hw + p) * C + c0);
    cnt += 1.f;
    const float inv = 1.f / cnt;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float val = T::load(pk.v[j]);
      const float d = val - mean[j];
      mean[j] += d * inv;
      m2[j] += d * (val - mean[j]);
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
  const int cpg = C / G;
  for (int g = t; g < G; g += blockDim.x) {
    Stats s = {0.f, 0.f, 0.f};
    for (int rr = 0; rr < rows; ++rr) {
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
        const Stats val = {sm_n[rr], sm_mean[rr * C + c], sm_m2[rr * C + c]};
        s = merge(s, val);
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

// NCHW apply: grid (N*C, chunks); block (nc, chunk) covers a chunk of the
// H*W elements of row nc = n*C + c (H*W % VEC == 0).
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(kRowThreads)
gn_apply_rows(const typename T::S* __restrict__ x, typename T::S* __restrict__ y,
              const float2* __restrict__ mean_rstd,
              const typename P::S* __restrict__ scale,
              const typename P::S* __restrict__ bias, int64_t hw, int C,
              int G, int silu) {
  using V = Pack<typename T::S, VEC>;
  const int64_t nc = blockIdx.x;
  const int c = static_cast<int>(nc % C);
  const float2 mr = mean_rstd[(nc / C) * G + c / (C / G)];
  const float a = mr.y * P::load(scale[c]);
  const float b = P::load(bias[c]);
  const int64_t nv = hw / VEC;
  const int64_t per = (nv + gridDim.y - 1) / gridDim.y;
  const int64_t v0 = blockIdx.y * per;
  const int64_t v1 = v0 + per < nv ? v0 + per : nv;
  const V* xv = reinterpret_cast<const V*>(x + nc * hw);
  V* yv = reinterpret_cast<V*>(y + nc * hw);
  const bool act = silu != 0;
  for (int64_t i = v0 + threadIdx.x; i < v1; i += blockDim.x) {
    const V in = xv[i];
    V out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = T::store(finish(T::load(in.v[j]), mr.x, a, b, act));
    yv[i] = out;
  }
}

// channels_last apply: grid (N, chunks), blockDim = rows * tpr as gn_stats_cl;
// thread t owns channels [c0, c0 + VEC) of positions r, r + rows, ...
template <typename T, typename P, int VEC>
__global__ void gn_apply_cl(const typename T::S* __restrict__ x,
                            typename T::S* __restrict__ y,
                            const float2* __restrict__ mean_rstd,
                            const typename P::S* __restrict__ scale,
                            const typename P::S* __restrict__ bias, int64_t hw,
                            int C, int G, int silu) {
  using V = Pack<typename T::S, VEC>;
  const int tpr = C / VEC;
  const int rows = blockDim.x / tpr;
  const int t = threadIdx.x;
  const int r = t / tpr;
  const int c0 = (t % tpr) * VEC;
  const int64_t n = blockIdx.x;
  const int cpg = C / G;
  float mean[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float2 mr = mean_rstd[n * G + (c0 + j) / cpg];
    mean[j] = mr.x;
    a[j] = mr.y * P::load(scale[c0 + j]);
    b[j] = P::load(bias[c0 + j]);
  }
  const int64_t per = (hw + gridDim.y - 1) / gridDim.y;
  const int64_t p0 = blockIdx.y * per;
  const int64_t p1 = p0 + per < hw ? p0 + per : hw;
  const int64_t step = static_cast<int64_t>(rows) * C;
  const typename T::S* src = x + (n * hw + p0 + r) * C + c0;
  typename T::S* dst = y + (n * hw + p0 + r) * C + c0;
  const bool act = silu != 0;
  for (int64_t p = p0 + r; p < p1; p += rows, src += step, dst += step) {
    const V in = *reinterpret_cast<const V*>(src);
    V out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = T::store(finish(T::load(in.v[j]), mean[j], a[j], b[j], act));
    *reinterpret_cast<V*>(dst) = out;
  }
}

// ------------------------------------------------------------- launchers
struct Args {
  const void* x;
  void* y;
  const void* scale;
  const void* bias;
  void* part;
  void* mean_rstd;
  int64_t n, hw;
  int c, groups, silu, channels_last, vec, slab_groups, cluster, ppb, chunks;
  float eps;
  cudaStream_t stream;
};

// Let a cluster kernel use all the shared memory a block can opt into and
// clusters of 16, once per device.
template <typename T, typename P, int VEC>
cudaError_t configure() {
  static bool done[64] = {};
  auto kernel = gn_cluster<T, P, VEC>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, typename P, int VEC>
cudaError_t launch_cluster(const Args& a) {
  using S = typename T::S;
  using PS = typename P::S;
  const int cpg = a.c / a.groups;
  const int run = a.slab_groups * cpg;
  const int tpp = run / VEC;
  if (a.groups % a.slab_groups || a.slab_groups > kMaxSlabGroups ||
      run % VEC || run > kMaxRunChannels || tpp < 1 || tpp > 16 ||
      (tpp & (tpp - 1)) || a.cluster < 1 || a.cluster > 16 || a.ppb < 1 ||
      static_cast<int64_t>(a.ppb) * a.cluster < a.hw)
    return cudaErrorInvalidValue;
  auto kernel = gn_cluster<T, P, VEC>;
  cudaError_t err = configure<T, P, VEC>();
  if (err != cudaSuccess) return err;
  const int slabs = a.groups / a.slab_groups;
  const int64_t blocks = a.n * slabs * a.cluster;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.ppb) * run * sizeof(S);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const S*>(a.x),
                           static_cast<S*>(a.y), static_cast<const PS*>(a.scale),
                           static_cast<const PS*>(a.bias),
                           static_cast<int>(a.hw), a.c, cpg, a.slab_groups,
                           a.ppb, slabs, a.eps, a.silu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename P, int VEC>
cudaError_t launch_two_pass(const Args& a) {
  using S = typename T::S;
  using PS = typename P::S;
  const S* xs = static_cast<const S*>(a.x);
  S* ys = static_cast<S*>(a.y);
  const PS* sc = static_cast<const PS*>(a.scale);
  const PS* bi = static_cast<const PS*>(a.bias);
  Stats* ps = static_cast<Stats*>(a.part);
  float2* mr = static_cast<float2*>(a.mean_rstd);
  const int64_t rows = a.n * a.groups;
  const int tpr = a.c / VEC;
  const int per_block = tpr >= 256 ? 1 : 256 / tpr;
  if (a.channels_last) {
    const size_t smem = (2 * static_cast<size_t>(per_block) * a.c + per_block) *
                        sizeof(float);
    gn_stats_cl<T, VEC><<<dim3(static_cast<unsigned>(a.n), a.chunks),
                          per_block * tpr, smem, a.stream>>>(xs, ps, a.hw, a.c,
                                                             a.groups);
  } else {
    gn_stats_rows<T, VEC><<<dim3(static_cast<unsigned>(rows), a.chunks),
                            kRowThreads, 0, a.stream>>>(
        xs, ps, static_cast<int64_t>(a.c / a.groups) * a.hw);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_combine<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, a.stream>>>(
      ps, mr, rows, a.chunks, a.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.channels_last) {
    gn_apply_cl<T, P, VEC><<<dim3(static_cast<unsigned>(a.n), a.chunks),
                             per_block * tpr, 0, a.stream>>>(
        xs, ys, mr, sc, bi, a.hw, a.c, a.groups, a.silu);
  } else {
    int64_t chunks = (a.hw / VEC + 4 * kRowThreads - 1) / (4 * kRowThreads);
    if (chunks > 65535) chunks = 65535;
    gn_apply_rows<T, P, VEC><<<dim3(static_cast<unsigned>(a.n * a.c),
                                    static_cast<unsigned>(chunks)),
                               kRowThreads, 0, a.stream>>>(
        xs, ys, mr, sc, bi, a.hw, a.c, a.groups, a.silu);
  }
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch(const Args& a) {
  constexpr int V = 16 / sizeof(typename T::S);
  if (a.cluster > 0)
    return a.vec == V && a.channels_last ? launch_cluster<T, P, V>(a)
                                         : cudaErrorInvalidValue;
  if (a.vec == V) return launch_two_pass<T, P, V>(a);
  if (a.vec == 1) return launch_two_pass<T, P, 1>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (N, C, H, W) of one dtype (is_bf16), both contiguous NCHW or both
// channels_last. scale, bias: (C,) contiguous, fp32 or bf16 (param_bf16).
// cluster > 0: the cluster kernel with slab_groups groups a slab, clusters
// of `cluster` blocks and ppb positions a block (channels_last, 16-byte
// vectors and alignment; part, mean_rstd and chunks unused). cluster == 0:
// the two-pass path with part (N*G*chunks*3 fp32), mean_rstd (N*G*2 fp32)
// and vec 1 or 16 bytes' worth of elements.
extern "C" int gn_silu_forward(const void* x, void* y, const void* scale,
                               const void* bias, void* part, void* mean_rstd,
                               long long n, long long c, long long hw,
                               int groups, float eps, int silu,
                               int channels_last, int is_bf16, int param_bf16,
                               int vec, int slab_groups, int cluster, int ppb,
                               int chunks, void* stream) {
  if (hw > 0x7fffffffLL || c > 0x7fffffffLL || groups < 1 || c % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {x, y, scale, bias, part, mean_rstd, n, hw,
                  static_cast<int>(c), groups, silu, channels_last, vec,
                  slab_groups, cluster, ppb, chunks, eps,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (is_bf16)
    err = param_bf16 ? dispatch<BF16, BF16>(a) : dispatch<BF16, F32>(a);
  else
    err = param_bf16 ? dispatch<F32, BF16>(a) : dispatch<F32, F32>(a);
  return static_cast<int>(err);
}

// out[0]: the shared memory (bytes) a block of this device can opt into;
// out[1]: 16 if the cluster kernel schedules clusters of 16 blocks with all
// of it, else 8 (the portable size).
// The caller makes `device` current.
extern "C" int gn_silu_device_limits(int device, int* out) {
  cudaError_t err = cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = gn_cluster<BF16, BF16, 8>;
  err = configure<BF16, BF16, 8>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = out[0] - attr.sharedSizeBytes;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = 16;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  out[1] = err == cudaSuccess && clusters > 0 ? 16 : 8;
  cudaGetLastError();  // a refused query leaves no sticky error
  return 0;
}
