// int8 x int8 -> int32 convolution with an fp32 epilogue, and the pass that
// quantizes activations to int8 codes, for Hopper (sm_90a).
//
// No TPU kernel stands behind these: the JAX package's int8 conv is XLA's
// convolution with int32 accumulation, lax.conv_general_dilated(xq, wq, ...,
// preferred_element_type=int32) in weatherforecastingtoolkit_tpu/ops/quant.py
// (int8_conv :104-108, int8_conv_static :159-163), and PyTorch has no int8
// convolution on CUDA. They compute the same function as that op and its
// epilogue:
//   y[n, ho, wo, co] = round_to_out(fp32(acc) * scale[co] + bias[co]),
//   acc = sum over (r, c, ci) of xq[n, ho*sh - pt + r, wo*sw - pl + c, ci]
//                              * wq[co, r, c, ci]   (zero outside the image)
// with each operation rounded as JAX rounds it: __int2float_rn, then
// __fmul_rn, then __fadd_rn (never contracted to an FMA), then
// __float2bfloat16_rn for a bf16 output. The sums are exact, so the result
// has the bits of a float64 convolution of the same codes followed by the
// same epilogue.
//
// Bound: at the VAE's shapes the conv is bound by its int8 operations
// (2*M*Cout*K over 1979e12 op/s, M = N*Ho*Wo, K = kh*kw*Cin) for
// Cin, Cout >= 128, and by bytes (codes read once, y written once, over
// 3.35e12 B/s) at Cout = 1 or at small Cin. The quantize pass is bound by
// bytes: x read once in its dtype, one int8 code written an element.
//
// Design (simple and right first): an implicit GEMM, M = N*Ho*Wo rows,
// Cout columns, K = kh*kw*Cp deep (Cp: Cin padded to 16 with zero codes, so
// a 16-byte piece of a row lies in one tap; the quantize pass writes that
// padding). A block of 4 warps owns a BM x BN output tile and walks K in
// 64-byte stages: each thread copies 16-byte pieces of the gathered input
// rows (zero-filled outside the image and past K) and of the weight rows into
// shared memory with cp.async, three stages in flight; the pieces of a row
// are XOR-swizzled so ldmatrix reads them without bank conflicts. Each warp
// runs mma.sync.m16n8k32 (s8 x s8 -> s32) on its (BM/WM) x (BN/WN) tile.
// Ragged M and Cout are masked (Cout = 1 and 16 occur). Three tile shapes:
// BN = 128 for Cout >= 128, 64 below, 16 for Cout <= 16. wgmma and TMA are
// later work.
//
// Entry points (plain C, loaded with ctypes): int8_conv2d_forward and
// int8_quantize_forward launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;        // bytes of K a stage
constexpr int kThreads = 128;  // 4 warps
constexpr int kStages = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads
// nothing.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0,
                                            unsigned& r1, unsigned& r2,
                                            unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte piece p (0..3) of tile row `row` (64 bytes a row):
// pieces XOR-swizzled by row, so the 8 rows of an ldmatrix phase fall in 8
// distinct bank groups.
__device__ __forceinline__ int swz(int row, int p) {
  return row * kBK + ((p ^ ((row >> 1) & 3)) << 4);
}

struct ConvArgs {
  const int8_t* x;      // (N, H, W, Cp)
  const int8_t* w;      // (Cout, kh, kw, Cp)
  const float* scale;   // (Cout,)
  const float* bias;    // (Cout,) or null
  void* out;            // (N, Ho, Wo, Cout), fp32 or bf16
  int n, h, w_, cp, cout, kh, kw, sh, sw, pt, pl, ho, wo;
  int m, k;             // M = N*Ho*Wo, K = kh*kw*Cp
  int n_tiles;          // ceil(Cout / BN)
};

__device__ __forceinline__ void store2(float* out, int64_t i, float a,
                                       float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, int64_t i, float a,
                                       float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(out + i) = v;
}

__device__ __forceinline__ void store1(float* out, int64_t i, float a) {
  out[i] = a;
}

__device__ __forceinline__ void store1(__nv_bfloat16* out, int64_t i,
                                       float a) {
  out[i] = __float2bfloat16_rn(a);
}

__device__ __forceinline__ float epilogue(int acc, const float* scale,
                                          const float* bias, int co) {
  const float y = __fmul_rn(__int2float_rn(acc), __ldg(scale + co));
  return bias ? __fadd_rn(y, __ldg(bias + co)) : y;
}

template <int BM, int BN, int WM, int WN, typename OUT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const ConvArgs p) {
  constexpr int kWarpM = BM / WM;
  constexpr int kWarpN = BN / WN;
  constexpr int kMT = kWarpM / 16;
  constexpr int kNT = kWarpN / 8;
  constexpr int kARows = BM / (kThreads / 4);  // A rows a thread copies
  static_assert(WM * WN == kThreads / 32, "4 warps");
  static_assert(kNT % 2 == 0, "B fragments load two n-tiles at once");
  static_assert(BM % (kThreads / 4) == 0, "A rows spread over the threads");

  // kStages A tiles (BM x 64 bytes), then kStages B tiles (BN x 64 bytes)
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* const a_s = smem;
  int8_t* const b_s = smem + kStages * BM * kBK;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int n_tile = blockIdx.x % p.n_tiles;
  const int m0 = (blockIdx.x / p.n_tiles) * BM;
  const int n0 = n_tile * BN;

  // the output rows this thread copies input for: piece column tid & 3,
  // rows (tid >> 2) + 32 i
  const int pc = tid & 3;
  const int8_t* a_base[kARows];
  int a_hi[kARows], a_wi[kARows];
  const int hw_out = p.ho * p.wo;
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + (tid >> 2) + i * (kThreads / 4);
    if (m < p.m) {
      const int img = m / hw_out;
      const int rem = m - img * hw_out;
      const int ho = rem / p.wo;
      const int wo = rem - ho * p.wo;
      a_base[i] = p.x + static_cast<int64_t>(img) * p.h * p.w_ * p.cp;
      a_hi[i] = ho * p.sh - p.pt;
      a_wi[i] = wo * p.sw - p.pl;
    } else {
      a_base[i] = p.x;
      a_hi[i] = -0x40000000;  // outside every image: zero rows
      a_wi[i] = 0;
    }
  }

  auto load_stage = [&](int slot, int kt) {
    const int k = kt * kBK + pc * 16;
    // the tap (r, c) and channel of this thread's piece of every row
    int r = 0, c = 0, ci = 0;
    const bool k_ok = k < p.k;
    if (k_ok) {
      const int tap = k / p.cp;
      ci = k - tap * p.cp;
      r = tap / p.kw;
      c = tap - r * p.kw;
    }
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int row = (tid >> 2) + i * (kThreads / 4);
      const int hi = a_hi[i] + r;
      const int wi = a_wi[i] + c;
      const bool ok = k_ok && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_;
      const int8_t* src =
          ok ? a_base[i] + (static_cast<int64_t>(hi) * p.w_ + wi) * p.cp + ci
             : p.x;
      cp_async16(smem_addr(a_s + slot * BM * kBK + swz(row, pc)), src,
                 ok ? 16 : 0);
    }
    for (int i = tid; i < BN * 4; i += kThreads) {
      const int row = i >> 2;
      const int q = i & 3;
      const int kq = kt * kBK + q * 16;
      const int co = n0 + row;
      const bool ok = co < p.cout && kq < p.k;
      const int8_t* src = ok ? p.w + static_cast<int64_t>(co) * p.k + kq : p.w;
      cp_async16(smem_addr(b_s + slot * BN * kBK + swz(row, q)), src,
                 ok ? 16 : 0);
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int k_tiles = (p.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt-1's slot is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const int slot = kt % kStages;
    const unsigned a_sm = smem_addr(a_s + slot * BM * kBK);
    const unsigned b_sm = smem_addr(b_s + slot * BN * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      unsigned b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        const int row = wn * kWarpN + j * 8 + (lane & 7) + (lane >> 4) * 8;
        const int piece = kk * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(b_sm + swz(row, piece), b[j][0], b[j][1], b[j + 1][0],
                    b[j + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        unsigned a[4];
        const int row = wm * kWarpM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int piece = kk * 2 + (lane >> 4);
        ldmatrix_x4(a_sm + swz(row, piece), a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows g and g+8, columns 2t and 2t+1 of each tile
  OUT* out = static_cast<OUT*>(p.out);
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool pairs = (p.cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * kWarpM + i * 16 + g + half * 8;
      if (m >= p.m) continue;
      const int64_t row = static_cast<int64_t>(m) * p.cout;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int co = n0 + wn * kWarpN + j * 8 + t4 * 2;
        if (co >= p.cout) continue;
        const float y0 = epilogue(acc[i][j][2 * half], p.scale, p.bias, co);
        if (pairs) {
          const float y1 =
              epilogue(acc[i][j][2 * half + 1], p.scale, p.bias, co + 1);
          store2(out, row + co, y0, y1);
        } else {
          store1(out, row + co, y0);
          if (co + 1 < p.cout)
            store1(out, row + co + 1,
                   epilogue(acc[i][j][2 * half + 1], p.scale, p.bias, co + 1));
        }
      }
    }
  }
}

// Allow `kernel` `bytes` of dynamic shared memory, once per device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_conv(ConvArgs p, bool bf16, cudaStream_t stream) {
  static bool done_f32[64] = {}, done_bf16[64] = {};
  constexpr int kSmem = kStages * (BM + BN) * kBK;
  p.n_tiles = (p.cout + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>((p.m + BM - 1) / BM) * p.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaError_t err;
  if (bf16) {
    auto kernel = int8_conv_kernel<BM, BN, WM, WN, __nv_bfloat16>;
    if ((err = allow_smem(kernel, kSmem, done_bf16)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, stream>>>(p);
  } else {
    auto kernel = int8_conv_kernel<BM, BN, WM, WN, float>;
    if ((err = allow_smem(kernel, kSmem, done_f32)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, stream>>>(p);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- quantize
// One thread per 16-byte run of output codes: channels 16j .. 16j+15 of one
// pixel, zero past C. q = clamp(rint(x / s), -127, 127) with IEEE division
// and round half to even, as jnp.round and torch.round.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int code(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

template <typename T, bool PER_CHANNEL, bool VEC>
__global__ void __launch_bounds__(256)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ s,
                int8_t* __restrict__ q, int64_t pixels, int c, int cp) {
  const int runs = cp / 16;
  const int64_t total = pixels * runs;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t pix = i / runs;
    const int c0 = static_cast<int>(i - pix * runs) * 16;
    const T* src = x + pix * c + c0;
    float v[16];
    if (VEC) {  // c % 16 == 0 and x 16-byte aligned: the run is 16 values
      if (sizeof(T) == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src) + e);
          v[4 * e] = f.x;
          v[4 * e + 1] = f.y;
          v[4 * e + 2] = f.z;
          v[4 * e + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + e);
          const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[8 * e + k] = __bfloat162float(b[k]);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = c0 + e < c ? to_f32(src[e]) : 0.f;
    }
    unsigned packed[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * w + b;
        int qv = 0;
        if (VEC || c0 + e < c)
          qv = code(v[e], PER_CHANNEL ? __ldg(s + c0 + e) : __ldg(s));
        word |= (static_cast<unsigned>(qv) & 0xffu) << (8 * b);
      }
      packed[w] = word;
    }
    *reinterpret_cast<uint4*>(q + i * 16) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

template <typename T, bool PER_CHANNEL>
cudaError_t launch_quantize(const T* x, const float* s, int8_t* q,
                            int64_t pixels, int c, int cp, bool vec,
                            cudaStream_t stream) {
  const int64_t total = pixels * (cp / 16);
  const int64_t blocks = (total + 255) / 256;
  const unsigned grid =
      static_cast<unsigned>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1)
                                              : 132 * 16);
  if (vec)
    quantize_kernel<T, PER_CHANNEL, true>
        <<<grid, 256, 0, stream>>>(x, s, q, pixels, c, cp);
  else
    quantize_kernel<T, PER_CHANNEL, false>
        <<<grid, 256, 0, stream>>>(x, s, q, pixels, c, cp);
  return cudaGetLastError();
}

}  // namespace

// xq: (N, H, W, Cp) int8, Cp % 16 == 0; wq: (Cout, kh, kw, Cp) int8; scale,
// bias: (Cout,) fp32 (bias may be null); out: (N, Ho, Wo, Cout), bf16 when
// out_bf16 else fp32. tile: 0 (BN 128), 1 (BN 64) or 2 (BN 16). All arrays
// contiguous, 16-byte aligned.
extern "C" int int8_conv2d_forward(const int8_t* xq, const int8_t* wq,
                                   const float* scale, const float* bias,
                                   void* out, int out_bf16, int n, int h,
                                   int w, int cp, int cout, int kh, int kw,
                                   int sh, int sw, int pt, int pl, int ho,
                                   int wo, int tile, void* stream) {
  if (cp % 16 || n < 1 || cout < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      ho < 1 || wo < 1 ||
      static_cast<int64_t>(n) * ho * wo > 0x7fffffffLL ||
      static_cast<int64_t>(kh) * kw * cp > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs p{xq, wq, scale, bias, out, n, h, w, cp, cout, kh, kw, sh, sw,
             pt, pl, ho, wo, n * ho * wo, kh * kw * cp, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 0: err = launch_conv<128, 128, 2, 2>(p, out_bf16, s); break;
    case 1: err = launch_conv<128, 64, 2, 2>(p, out_bf16, s); break;
    case 2: err = launch_conv<128, 16, 4, 1>(p, out_bf16, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// x: (pixels, C) fp32 or bf16 (x_bf16), contiguous; s: (C,) fp32 when
// per_channel else one fp32; q: (pixels, Cp) int8, Cp = C rounded up to 16.
extern "C" int int8_quantize_forward(const void* x, int x_bf16,
                                     const float* s, int per_channel,
                                     int8_t* q, long long pixels, int c,
                                     int cp, void* stream) {
  if (c < 1 || cp % 16 || cp < c || cp - c >= 16 || pixels < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = c % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (x_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    err = per_channel
              ? launch_quantize<__nv_bfloat16, true>(xb, s, q, pixels, c, cp,
                                                     vec, st)
              : launch_quantize<__nv_bfloat16, false>(xb, s, q, pixels, c, cp,
                                                      vec, st);
  } else {
    const float* xf = static_cast<const float*>(x);
    err = per_channel
              ? launch_quantize<float, true>(xf, s, q, pixels, c, cp, vec, st)
              : launch_quantize<float, false>(xf, s, q, pixels, c, cp, vec,
                                              st);
  }
  return static_cast<int>(err);
}
