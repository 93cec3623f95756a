// Advection-diffusion residual loss, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel weatherforecastingtoolkit_tpu/ops/pallas/stencil.py
// `_stencil_kernel` (launched by `advection_diffusion_loss`). It computes the
// same function on x of shape (B, T, C, H, W), fp32: for every frame pair
// (x0, x1) = (x[b, t, c], x[b, t+1, c]) the interior residual
//   r = (x1 - x0) + u * dx0/dw + v * dx0/dh - kappa * lap(x0)
// with central differences and the 5-point Laplacian, and returns
// sum(r^2) / (n * (H-2) * (W-2)), n = B * C * (T-1).
//
// Bound: device-memory bytes. The function reads x once (B*T*C*H*W*4 bytes)
// and does 14 flops per interior element and pair. At the training batch of
// 2 that is 1.57 MB, under one launch's latency; the kernel is launch-bound
// there.
//
// Design. The TPU kernel takes one whole frame pair per grid step and adds
// each step's sum into one SMEM cell, relying on the grid running in order.
// Hopper blocks run at the same time, so that cannot carry over:
//   1. partials: one block per (frame pair, band of interior rows) reads x in
//      place (no transpose, no x0/x1 copies: frame t+1 of the same channel is
//      C*H*W elements further on), forms r^2 for its elements, reduces them in
//      fp32 with warp shuffles and then shared memory, and writes one partial;
//   2. finish: one block sums the partials in a fixed order (in fp64) and
//      divides by n * (H-2) * (W-2).
// No float atomics, so two runs give the same bits. Neighbouring threads read
// neighbouring columns; the five reads of x0 around an element hit L1 for all
// but the first.
//
// Entry point: advection_stencil_forward (plain C, loaded with ctypes). It
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// grid: n_pairs * bands blocks; part[pair * bands + band].
__global__ void __launch_bounds__(kThreads)
stencil_partials(const float* __restrict__ x, const float* __restrict__ params,
                 float* __restrict__ part, int t, int c, int h, int w,
                 int band_rows, int bands) {
  const int64_t blk = blockIdx.x;
  const int64_t pair = blk / bands;
  const int band = static_cast<int>(blk - pair * bands);
  // pair = (b * C + c) * (T-1) + t, the order of the JAX frames' (B*C, T-1)
  const int64_t per_b = static_cast<int64_t>(c) * (t - 1);
  const int64_t bi = pair / per_b;
  const int64_t rem = pair - bi * per_b;
  const int64_t ci = rem / (t - 1);
  const int64_t ti = rem - ci * (t - 1);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const float* x0 = x + ((bi * t + ti) * c + ci) * hw;
  const float* x1 = x0 + static_cast<int64_t>(c) * hw;
  const float u = params[0];
  const float v = params[1];
  const float kappa = params[2];

  const int iw = w - 2;
  const int row0 = 1 + band * band_rows;
  const int rows = min(band_rows, h - 1 - row0);
  const int count = rows * iw;
  float s = 0.f;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int i = row0 + k / iw;
    const int j = 1 + k % iw;
    const int64_t at = static_cast<int64_t>(i) * w + j;
    const float cen = x0[at];
    const float up = x0[at - w];
    const float dn = x0[at + w];
    const float lf = x0[at - 1];
    const float rt = x0[at + 1];
    const float dt = x1[at] - cen;
    const float dh = (dn - up) * 0.5f;
    const float dw = (rt - lf) * 0.5f;
    const float lap = dn + up + rt + lf - 4.0f * cen;
    const float r = dt + u * dw + v * dh - kappa * lap;
    s += r * r;
  }

  __shared__ float warps[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) warps[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? warps[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) part[blk] = s;
  }
}

// One block: thread k sums partials k, k + 1024, ... in order, then a fixed
// tree over the threads.
__global__ void __launch_bounds__(kFinishThreads)
stencil_finish(const float* __restrict__ part, int64_t n_part, double denom,
               float* __restrict__ out) {
  __shared__ double sums[kFinishThreads];
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < n_part; i += kFinishThreads) s += part[i];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int off = kFinishThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sums[threadIdx.x] += sums[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(sums[0] / denom);
}

}  // namespace

// x: contiguous (B, T, C, H, W) fp32, T >= 2, H >= 3, W >= 3.
// params: 3 fp32 (u, v, kappa) on the device. part: B*C*(T-1)*bands fp32,
// bands = ceil((H-2) / band_rows). out: 1 fp32.
extern "C" int advection_stencil_forward(const float* x, const float* params,
                                         float* part, float* out, long long b,
                                         int t, int c, int h, int w,
                                         int band_rows, void* stream) {
  if (t < 2 || h < 3 || w < 3 || band_rows < 1 || b < 1 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bands = (h - 2 + band_rows - 1) / band_rows;
  const int64_t pairs = static_cast<int64_t>(b) * c * (t - 1);
  const int64_t blocks = pairs * bands;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stencil_partials<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, params, part, t, c, h, w, band_rows, bands);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const double denom =
      static_cast<double>(pairs) * (h - 2) * static_cast<double>(w - 2);
  stencil_finish<<<1, kFinishThreads, 0, st>>>(part, blocks, denom, out);
  return static_cast<int>(cudaGetLastError());
}
