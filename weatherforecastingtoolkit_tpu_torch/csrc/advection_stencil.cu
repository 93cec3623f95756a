// Advection-diffusion residual loss, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel weatherforecastingtoolkit_tpu/ops/pallas/stencil.py
// `_stencil_kernel` (launched by `advection_diffusion_loss`). It computes the
// same function on x of shape (B, T, C, H, W), fp32 or bf16: for every frame
// pair (x0, x1) = (x[b, t, c], x[b, t+1, c]) the interior residual
//   r = (x1 - x0) + u * dx0/dw + v * dx0/dh - kappa * lap(x0)
// with central differences and the 5-point Laplacian, and returns
// sum(r^2) / (n * (H-2) * (W-2)), n = B * C * (T-1).
//
// bf16 x: the differences dt, dh, dw and lap are bf16, each operation
// rounded to bf16 (from its fp32 result) left to right as the JAX source
// writes them: dt = x1 - x0, dh = (dn - up) * 0.5, dw = (rt - lf) * 0.5,
// lap = (((dn + up) + rt) + lf) - 4 * c. u, v and kappa are fp32 (the
// kernel's params_ref), so under jnp's promotion u*dw, v*dh, kappa*lap and
// r = ((dt + u*dw) + v*dh) - kappa*lap are fp32, as are r^2 and the sum.
// The tiles hold bf16 in shared memory; the fp32 path is unchanged.
//
// Bound: device-memory bytes. The function reads x once (B*T*C*H*W*4 bytes)
// and does 14 flops per interior element and pair. At the training batch of
// 2 that is 1.57 MB, 0.47 us at 3.35 TB/s: there one launch's latency and
// the chain of dependent memory round trips inside it are the cost. The
// first design took two launches (partials, then a one-block finish) and
// read every frame twice (as x1 of one pair and x0 of the next).
//
// Design (one launch, each frame read once). The TPU kernel takes one whole
// frame pair per grid step and adds each step's sum into one SMEM cell,
// relying on the grid running in order. Here a block owns (b, c, a band of
// interior rows) and walks t:
//   - it keeps a ring of frames' bands (each with its two halo rows) in
//     shared memory, filled with cp.async (16-byte copies when W % 4 == 0
//     and x is aligned, else 4-byte ones) up to `ring` frames ahead, so
//     frame t+1 is read once and serves as x1 of pair t and x0 of pair t+1;
//     with ring >= T every frame of the band is in flight at once and the
//     (pair, row) tasks spread over the block with one barrier;
//   - threads map 2D onto (row, 4-column vector) of the band: no division
//     per element; the left and right neighbours of a vector are two more
//     shared-memory reads;
//   - the band height follows B*C: 2-row bands at B=2 (126 blocks);
//   - each block reduces its r^2 with fixed shuffle trees, writes its fp32
//     partial and takes a ticket with one release-acquire integer atomic;
//     the last block sums all partials in a fixed order in fp64 (eight loads
//     in flight a thread), divides, and returns the ticket counter to zero
//     (so the next launch, or a CUDA graph replay, starts from zero). No
//     float atomics: two runs give the same bits.
// x is read where it lies: strides for b, t and c, with each (H, W) frame
// dense, so a channel slice needs no copy. u, v and kappa are three device
// scalars, read by pointer, so the caller needs no kernel to pack them.
//
// Entry points (plain C, loaded with ctypes): advection_stencil_forward
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(); advection_stencil_capture_id names the CUDA graph
// capture a stream is recording, so that the caller gives each captured
// launch a ticket counter of its own.

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTX = 32;  // threads along a row: vectors of 4 columns
constexpr int kTY = 8;   // threads along the band's rows
constexpr int kThreads = kTX * kTY;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRing = 16;

// A fixed tree over the lanes; lane 0 ends with the total.
template <typename F>
__device__ __forceinline__ F warp_sum(F s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// The block's total in thread 0, in a fixed order: a tree in each warp,
// then a tree over the warps' sums in warp 0.
template <typename F>
__device__ __forceinline__ F block_sum(F s, F* warps) {
  const int lane = threadIdx.x & 31;
  s = warp_sum(s);
  if (lane == 0) warps[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) s = warp_sum(lane < kWarps ? warps[lane] : F(0));
  return s;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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

// Wait until at most `pending` copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    default: cp_async_wait<14>(); break;
  }
}

// The band of frame `src` (rows row0-1 .. row0+rows, contiguous) into `dst`:
// 16-byte copies (VEC4), else 4-byte copies (fp32) or plain stores (bf16).
template <typename E, bool VEC4>
__device__ __forceinline__ void load_band(E* dst, const E* src, int count) {
  constexpr int kVec = 16 / sizeof(E);
  if (VEC4) {
    for (int i = threadIdx.x; i < count / kVec; i += kThreads)
      cp_async<16>(dst + kVec * i, src + kVec * i);
  } else if (std::is_same<E, float>::value) {
    for (int i = threadIdx.x; i < count; i += kThreads)
      cp_async<4>(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
  cp_async_commit();
}

__device__ __forceinline__ float residual2(float cen, float up, float dn,
                                           float lf, float rt, float nxt,
                                           float u, float v, float kappa) {
  const float dt = nxt - cen;
  const float dh = (dn - up) * 0.5f;
  const float dw = (rt - lf) * 0.5f;
  const float lap = dn + up + rt + lf - 4.0f * cen;
  const float r = dt + u * dw + v * dh - kappa * lap;
  return r * r;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// r^2 for bf16 x (see the header): the differences rounded to bf16 one
// operation at a time, the residual in fp32 without contraction.
__device__ __forceinline__ float residual2_bf16(float cen, float up, float dn,
                                                float lf, float rt, float nxt,
                                                float u, float v,
                                                float kappa) {
  const float dt = bf16_round(nxt - cen);
  const float dh = bf16_round(bf16_round(dn - up) * 0.5f);
  const float dw = bf16_round(bf16_round(rt - lf) * 0.5f);
  const float lap = bf16_round(
      bf16_round(bf16_round(bf16_round(dn + up) + rt) + lf) -
      bf16_round(4.0f * cen));
  const float r = __fsub_rn(
      __fadd_rn(__fadd_rn(dt, __fmul_rn(u, dw)), __fmul_rn(v, dh)),
      __fmul_rn(kappa, lap));
  return __fmul_rn(r, r);
}

// Sum of r^2 over the columns of interior row i of pair (a, b), bf16 x:
// threads along the row, one element each (VEC4 only shapes the copies).
template <bool VEC4>
__device__ __forceinline__ float row_sum(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int i, int w,
                                         float u, float v, float kappa) {
  const int tx = threadIdx.x % kTX;
  const __nv_bfloat16* row = a + i * w;
  float s = 0.f;
  for (int j = 1 + tx; j < w - 1; j += kTX)
    s += residual2_bf16(
        __bfloat162float(row[j]), __bfloat162float(row[j - w]),
        __bfloat162float(row[j + w]), __bfloat162float(row[j - 1]),
        __bfloat162float(row[j + 1]), __bfloat162float(b[i * w + j]), u, v,
        kappa);
  return s;
}

// Sum of r^2 over the columns of interior row i of pair (a, b), threads
// along the row: a and b are bands of interior rows plus the halo rows, w
// floats a row.
template <bool VEC4>
__device__ __forceinline__ float row_sum(const float* a, const float* b,
                                         int i, int w, float u, float v,
                                         float kappa) {
  const int tx = threadIdx.x % kTX;
  const float* row = a + i * w;
  float s = 0.f;
  if (VEC4) {
    for (int j0 = 4 * tx; j0 < w; j0 += 4 * kTX) {
      const float4 cen = *reinterpret_cast<const float4*>(row + j0);
      const float4 up = *reinterpret_cast<const float4*>(row - w + j0);
      const float4 dn = *reinterpret_cast<const float4*>(row + w + j0);
      const float4 nxt = *reinterpret_cast<const float4*>(b + i * w + j0);
      // columns j0+1 and j0+2 are interior (w % 4 == 0); j0 is not when it
      // is column 0, j0+3 not when it is column w-1
      if (j0 > 0)
        s += residual2(cen.x, up.x, dn.x, row[j0 - 1], cen.y, nxt.x, u, v,
                       kappa);
      s += residual2(cen.y, up.y, dn.y, cen.x, cen.z, nxt.y, u, v, kappa);
      s += residual2(cen.z, up.z, dn.z, cen.y, cen.w, nxt.z, u, v, kappa);
      if (j0 + 4 < w)
        s += residual2(cen.w, up.w, dn.w, cen.z, row[j0 + 4], nxt.w, u, v,
                       kappa);
    }
  } else {
    for (int j = 1 + tx; j < w - 1; j += kTX)
      s += residual2(row[j], row[j - w], row[j + w], row[j - 1], row[j + 1],
                     b[i * w + j], u, v, kappa);
  }
  return s;
}

// grid: B * C * bands blocks; block = (b, c, band). Dynamic shared memory:
// ring * (band_rows + 2) * W elements. part: one float a block; ticket: an
// unsigned counter that is zero between launches.
template <typename E, bool VEC4>
__global__ void __launch_bounds__(kThreads)
stencil_fused(const E* __restrict__ x, const float* __restrict__ u_ptr,
              const float* __restrict__ v_ptr,
              const float* __restrict__ kappa_ptr, float* __restrict__ part,
              unsigned* __restrict__ ticket, float* __restrict__ out, int T,
              int C, int H, int W, int64_t sb, int64_t st, int64_t sc,
              int band_rows, int bands, int ring, double denom) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* const tiles = reinterpret_cast<E*>(smem_raw);
  __shared__ float warps[kWarps];
  __shared__ double sums[kWarps];
  __shared__ bool last;

  const int band = blockIdx.x % bands;
  const int bc = blockIdx.x / bands;
  const int c = bc % C;
  const int b = bc / C;
  const int row0 = 1 + band * band_rows;
  const int rows = min(band_rows, H - 1 - row0);
  const int count = (rows + 2) * W;
  const int pitch = (band_rows + 2) * W;
  const E* frame0 = x + b * sb + c * sc + static_cast<int64_t>(row0 - 1) * W;
  const float u = *u_ptr;
  const float v = *v_ptr;
  const float kappa = *kappa_ptr;

  const int ty = threadIdx.x / kTX;
  float s = 0.f;
  if (ring >= T) {
    // every frame of the band in flight at once; then the (pair, row) tasks
    // spread over the thread rows
    for (int f = 0; f < T; ++f)
      load_band<E, VEC4>(tiles + f * pitch, frame0 + f * st, count);
    cp_async_wait<0>();
    __syncthreads();
    for (int task = ty; task < (T - 1) * rows; task += kTY) {
      const int t = task / rows;
      const E* a = tiles + t * pitch;
      s += row_sum<VEC4>(a, a + pitch, 1 + task - t * rows, W, u, v, kappa);
    }
  } else {
    // a ring: the first `ring` frames in flight, then one more a pair
    int issued = 0;
    for (; issued < ring; ++issued)
      load_band<E, VEC4>(tiles + issued * pitch, frame0 + issued * st,
                         count);
    int slot0 = 0;
    for (int t = 0; t + 1 < T; ++t) {
      cp_async_wait_pending(issued - (t + 2));
      __syncthreads();
      const int slot1 = slot0 + 1 == ring ? 0 : slot0 + 1;
      for (int i = 1 + ty; i <= rows; i += kTY)
        s += row_sum<VEC4>(tiles + slot0 * pitch, tiles + slot1 * pitch, i, W,
                           u, v, kappa);
      __syncthreads();  // frame t's slot is free
      if (issued < T) {
        load_band<E, VEC4>(tiles + slot0 * pitch, frame0 + issued * st,
                           count);
        ++issued;
      }
      slot0 = slot1;
    }
  }

  s = block_sum(s, warps);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    // release: the partial is visible before the ticket; acquire: the last
    // block sees every partial
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> tk(*ticket);
    last = tk.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: all partials, in a fixed order, in fp64; thread k sums
  // partials k, k + kThreads, ... in order, eight loads in flight at a time
  const int n_part = static_cast<int>(gridDim.x);
  double acc = 0.0;
  for (int i0 = threadIdx.x; i0 < n_part; i0 += 8 * kThreads) {
    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads;
      p[j] = i < n_part ? __ldcg(part + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += p[j];
  }
  acc = block_sum(acc, sums);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(acc / denom);
    *ticket = 0u;
  }
}

template <typename E, bool VEC4>
cudaError_t launch(const E* x, const float* u, const float* v,
                   const float* kappa, float* part, unsigned* ticket,
                   float* out, int64_t b, int t, int c, int h, int w,
                   int64_t sb, int64_t st, int64_t sc, int band_rows,
                   int ring, cudaStream_t stream) {
  const int bands = (h - 2 + band_rows - 1) / band_rows;
  const int64_t blocks = b * c * bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(ring) * (band_rows + 2) * w * sizeof(E);
  auto kernel = stencil_fused<E, VEC4>;
  // shared memory beyond the default 48 KB a block (static included) only
  // after opting in: all a block can have, once per device
  static bool configured[64] = {};  // one flag set per instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  const double denom =
      static_cast<double>(b) * c * (t - 1) * (h - 2) * static_cast<double>(w - 2);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, u, v, kappa, part, ticket, out, t, c, h, w, sb, st, sc, band_rows,
      bands, ring, denom);
  return cudaGetLastError();
}

}  // namespace

// x: (B, T, C, H, W) fp32, or bf16 when bf16 != 0, with element strides sb,
// st, sc for B, T, C and each (H, W) frame dense; T >= 2, H >= 3, W >= 3. u,
// v, kappa: one fp32 each on the device. part: B*C*bands fp32, bands =
// ceil((H-2) / band_rows). ticket: one unsigned, zero. out: 1 fp32. vec4:
// 16-byte copies (W a multiple of 16 bytes' elements, x and the strides
// 16-byte aligned). ring: frames kept on chip, 2..16.
extern "C" int advection_stencil_forward(
    const void* x, const float* u, const float* v, const float* kappa,
    float* part, unsigned* ticket, float* out, long long b, int t, int c,
    int h, int w, long long sb, long long st, long long sc, int band_rows,
    int ring, int vec4, int bf16, void* stream) {
  if (t < 2 || h < 3 || w < 3 || band_rows < 1 || b < 1 || c < 1 ||
      ring < 2 || ring > kMaxRing || (vec4 && w % (bf16 ? 8 : 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    err = vec4 ? launch<__nv_bfloat16, true>(xb, u, v, kappa, part, ticket,
                                             out, b, t, c, h, w, sb, st, sc,
                                             band_rows, ring, s)
               : launch<__nv_bfloat16, false>(xb, u, v, kappa, part, ticket,
                                              out, b, t, c, h, w, sb, st, sc,
                                              band_rows, ring, s);
  } else {
    const float* xf = static_cast<const float*>(x);
    err = vec4 ? launch<float, true>(xf, u, v, kappa, part, ticket, out, b, t,
                                     c, h, w, sb, st, sc, band_rows, ring, s)
               : launch<float, false>(xf, u, v, kappa, part, ticket, out, b,
                                      t, c, h, w, sb, st, sc, band_rows, ring,
                                      s);
  }
  return static_cast<int>(err);
}

// The id of the capture `stream` is recording into a CUDA graph, 0 when it
// records none (or the query fails).
extern "C" unsigned long long advection_stencil_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}
