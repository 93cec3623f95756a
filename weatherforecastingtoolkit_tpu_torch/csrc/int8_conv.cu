// int8 x int8 -> int32 convolution with an fp32 epilogue, and the pass that
// quantizes activations to int8 codes, for Hopper (sm_90a).
//
// What they replace. No TPU kernel stands behind these: the JAX package's
// int8 conv is XLA's convolution with int32 accumulation,
// lax.conv_general_dilated(xq, wq, ..., preferred_element_type=int32) in
// weatherforecastingtoolkit_tpu/ops/quant.py (int8_conv :106, int8_conv_static
// :161), and PyTorch has no int8 convolution on CUDA. They compute the same
// function as that op and its epilogue:
//   y[n, ho, wo, co] = round_to_out(fp32(acc) * scale[co] + bias[co]),
//   acc = sum over (r, c, ci) of xq[n, ho*sh - pt + r, wo*sw - pl + c, ci]
//                              * wq[co, r, c, ci]   (zero outside the image)
// with each operation rounded as JAX rounds it: __int2float_rn, then
// __fmul_rn, then __fadd_rn (never contracted to an FMA), then
// __float2bfloat16_rn for a bf16 output. The sums are exact, so the result
// has the bits of a float64 convolution of the same codes followed by the
// same epilogue.
//
// What bounds them. The conv is an implicit GEMM, M = N*Ho*Wo rows, Cout
// columns, K = kh*kw*Cp deep (Cp: Cin padded to 16 with zero codes, so a
// 16-byte piece of a row lies in one tap; the quantize pass writes that
// padding). At the VAE's shapes it is bound by its int8 operations
// (2*M*Cout*K over 1979e12 op/s) for Cin, Cout >= 128, and by bytes (codes
// read once, y written once, over 3.35e12 B/s) at Cout = 1 or small Cin.
// The gathered rows are read kh*kw times from L2 (M*K bytes of A), and the
// weights once per 128-row tile (M/128 * Cout*K bytes of B), so the
// L2-to-shared traffic and the rate at which it can be issued come next.
// The quantize pass is bound by bytes.
//
// The design, against the five limits of the mma.sync kernel it replaced
// (one block of 4 warps per 128 x BN tile, 64-byte stages):
//  1. Tensor cores: wgmma.mma_async m64nNk32 s8 x s8 -> s32 with both
//     operands read from shared memory by descriptors (both K-major: NHWC
//     codes for A, the packed (Cout, K) weight matrix for B), N = 256, 128,
//     64, 16 or 8 by Cout, not mma.sync from ldmatrix fragments.
//  2. Stages and overlap: stages of 128 bytes of K in the 128-byte swizzle
//     (64 bytes in the 64-byte one where Cp is an odd multiple of 64), each
//     feeding 4 (2) k32 steps, in a ring of 4-16 stages sized to the 227 KB.
//     Warp specialised: a producer warpgroup fills the ring, two consumer
//     warpgroups (64 rows each) hold the s32 sums in registers; full and
//     empty mbarriers between them, no __syncthreads() in the main loop;
//     setmaxnreg moves registers from the producers to the consumers.
//  3. Operand loads: the weights come by TMA (cp.async.bulk.tensor.2d,
//     zero-filled past K and Cout), per stage or, where one tile spans
//     Cout, all of them once per block (resident). The input rows come by
//     TMA in im2col mode where the geometry allows it (design 2: one
//     instruction a stage for 128 rows of one tap, the padding and stride in
//     the tensor map, out-of-bounds pixels zero): every serving shape but
//     conv_in. Elsewhere two producer warpgroups gather them in 16-byte
//     cp.async pieces completed on the stage's mbarrier
//     (cp.async.mbarrier.arrive.noinc), written in the swizzle wgmma reads
//     (design 1); each row's in-image taps are a bit mask made once a tile,
//     a piece's tap and channel are walked stage to stage, not divided. The
//     consumers fence the async proxy (fence.proxy.async.shared::cta) after
//     each full barrier, since cp.async writes through the generic proxy.
//  4. Scheduling: persistent, one block per SM walks the output tiles in a
//     fixed order (tile = blockIdx.x + i*gridDim.x, Cout tiles fastest), no
//     counter; the producer runs ahead into the next tile while the
//     consumers finish one, so a tile's epilogue overlaps the next loads.
//  5. Stores and the weight side: the epilogue stages each warp's 16 rows
//     through shared memory, 32 columns at a time, so each thread stores 16
//     contiguous bytes; the weight side (codes, packing, folded scales) is
//     built once per QConv by ops/quant.py, not on every call.
// The plan (design, tile, ring, residency) is chosen in Python
// (ops/cuda/int8_conv.py::plan), from the times kernel_timing.py measures.
//
// Entry points (plain C, loaded with ctypes): int8_conv2d_forward and
// int8_quantize_forward launch on the caller's stream, allocate nothing and
// return a CUDA error code (0 on success).

#include <cuda.h>  // CUtensorMap and its enums (the encoders: see below)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct ConvArgs {
  const int8_t* x;      // (N, H, W, Cp)
  const int8_t* w;      // (Cout, kh, kw, Cp) = the (Cout, K) matrix
  const float* scale;   // (Cout,)
  const float* bias;    // (Cout,) or null
  void* out;            // (N, Ho, Wo, Cout), fp32 or bf16
  int n, h, w_, cp, cout, kh, kw, sh, sw, pt, pl, ho, wo;
  int m, k;             // M = N*Ho*Wo, K = kh*kw*Cp
  int n_tiles;          // ceil(Cout / BN)
  int m_tiles;          // ceil(M / BM)
  int k_tiles;          // ceil(K / bytes of K a stage)
  int stages;           // ring depth
  int b_resident;       // all of B held in shared memory (one Cout tile)
};

__device__ __forceinline__ float epilogue(int acc, float scale,
                                          const float* bias, int co) {
  const float y = __fmul_rn(__int2float_rn(acc), scale);
  return bias ? __fadd_rn(y, __ldg(bias + co)) : y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// ------------------------------------- the warp-specialised wgmma design
constexpr int kWsBM = 128;       // output rows a tile, 64 a consumer
constexpr int kWsBK = 128;       // bytes of K a stage: one 128-byte swizzle row
constexpr int kWsABytes = kWsBM * kWsBK;
// PW producer warpgroups (2 for the gather, 1 for im2col), then two
// consumer warpgroups; setmaxnreg moves registers from the producers to the
// consumers (which hold the sums); ptxas allocates the launch's 65536 /
// threads registers a thread, so the gather's tiles stop at 128 wide.
__host__ __device__ constexpr int ws_threads(int pw) { return 128 * (pw + 2); }
__host__ __device__ constexpr int producer_regs(int pw) {
  return pw == 1 ? 56 : 40;
}
__host__ __device__ constexpr int consumer_regs(int pw) {
  return pw == 1 ? 224 : 216;
}
constexpr int kEpiCols = 32;     // output columns a warp stages at a time
constexpr int kSmemLimit = 232448;

template <int N>
struct Acc {
  int d[N / 2];
};

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with parity `parity` has completed. A wait
// that lasts seconds can only be a fault of the protocol: trap (the launch
// fails with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  uint64_t t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) t0 = now;
    if (now - t0 > 4000000000ull) __trap();
  }
}

// TMA: the box at (c0 along K, c1 along Cout) of the weight matrix into
// shared memory at dst, completing `bytes` on bar.
__device__ __forceinline__ void tma_load_2d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the sums across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void acc_fence(Acc<N>& a) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+r"(a.d[i])::"memory");
}

// Descriptor of a K-major operand in the BK-byte swizzle (BK = 128 or 64):
// rows of BK bytes, 8-row groups 8 * BK bytes apart (SBO), the leading
// offset unused; the tile starts 8 * BK-byte aligned. Adding 2 steps 32
// bytes along K.
template <int BK>
__device__ __forceinline__ uint64_t make_desc(unsigned addr) {
  static_assert(BK == 128 || BK == 64, "the 128- or 64-byte swizzle");
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * BK >> 4) << 32) |
         ((BK == 128 ? 1ull : 2ull) << 62);
}

#define R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define R16(i) R4(i), R4(i + 4), R4(i + 8), R4(i + 12)

__device__ __forceinline__ void wgmma_s8(Acc<8>& a, uint64_t da,
                                         uint64_t db) {
  int* d = a.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : R4(0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(Acc<16>& a, uint64_t da,
                                         uint64_t db) {
  int* d = a.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : R4(0), R4(4)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(Acc<64>& a, uint64_t da,
                                         uint64_t db) {
  int* d = a.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p;\n}\n"
      : R16(0), R16(16)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(Acc<128>& a, uint64_t da,
                                         uint64_t db) {
  int* d = a.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : R16(0), R16(16), R16(32), R16(48)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(Acc<256>& a, uint64_t da,
                                         uint64_t db) {
  int* d = a.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : R16(0), R16(16), R16(32), R16(48),
        R16(64), R16(80), R16(96), R16(112)
      : "l"(da), "l"(db), "r"(1));
}

#undef R16
#undef R4
// Shared memory of the wgmma kernels: 1024 bytes of alignment slack, the
// A ring, the B operand (a ring of stages, or all of B when resident), the
// epilogue's staging rows (8 warps x 16 rows) and the barriers.
template <int BN, typename OUT>
__host__ __device__ constexpr int ws_epi_stride() {
  return (BN < kEpiCols ? BN : kEpiCols) * static_cast<int>(sizeof(OUT)) + 16;
}

template <int BN, int BK, typename OUT>
int ws_smem_bytes(const ConvArgs& p) {
  return 1024 + p.stages * kWsBM * BK +
         (p.b_resident ? p.k_tiles : p.stages) * BN * BK +
         8 * 16 * ws_epi_stride<BN, OUT>() + 16 * p.stages + 8;
}

// Where a wgmma kernel keeps things in shared memory.
struct WsSmem {
  uint8_t* smem;     // 1024-byte aligned
  unsigned a_s;      // A ring: stages x (128 rows x BK bytes)
  unsigned b_s;      // B ring (stages x BN x BK) or all of B (k_tiles boxes)
  int epi_off;       // staging rows, from smem
  unsigned bars;     // full[s], empty[s], then the resident weights' barrier
};

template <int BN, int BK, typename OUT>
__device__ __forceinline__ WsSmem ws_smem(uint8_t* smem_raw,
                                          const ConvArgs& p) {
  WsSmem s;
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  s.smem = smem_raw + (base - raw);
  s.a_s = base;
  s.b_s = base + p.stages * kWsBM * BK;
  s.epi_off = (s.b_s - base) + (p.b_resident ? p.k_tiles : p.stages) * BN * BK;
  s.bars = base + s.epi_off + 8 * 16 * ws_epi_stride<BN, OUT>();
  return s;
}

// The epilogue of one 64 x BN block of sums (this warpgroup's rows of the
// tile at m0, n0): this thread holds rows g and g + 8 of its warp's 16 and
// columns 8 q + 2 t4 + {0, 1}; they are rounded as JAX rounds them and
// staged through shared memory kCh columns at a time, so that each thread
// stores 16 contiguous bytes.
template <int BN, typename OUT>
__device__ __forceinline__ void ws_epilogue(const ConvArgs& p, Acc<BN>& acc,
                                            uint8_t* ebuf, int m0, int n0,
                                            int wg, int ct) {
  constexpr int kCh = BN < kEpiCols ? BN : kEpiCols;
  constexpr int kStride = ws_epi_stride<BN, OUT>();
  static_assert(kStride % 16 == 0, "16-byte rows in the staging buffer");
  const int warp = (ct >> 5) & 3;      // rows 16 warp .. of the warpgroup's
  const int lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  OUT* const out = static_cast<OUT*>(p.out);
  const bool vec = (p.cout * static_cast<int>(sizeof(OUT))) % 16 == 0;
  const int wrow = m0 + wg * 64 + warp * 16;
#pragma unroll
  for (int c0 = 0; c0 < BN; c0 += kCh) {
    if (n0 + c0 >= p.cout) break;
#pragma unroll
    for (int q = c0 / 8; q < (c0 + kCh) / 8; ++q) {
      const int cl = q * 8 - c0 + 2 * t4;
      const int co = n0 + q * 8 + 2 * t4;
      const float s0 = co < p.cout ? __ldg(p.scale + co) : 0.f;
      const float s1 = co + 1 < p.cout ? __ldg(p.scale + co + 1) : 0.f;
      const float* bias0 = co < p.cout ? p.bias : nullptr;
      const float* bias1 = co + 1 < p.cout ? p.bias : nullptr;
      OUT* e0 = reinterpret_cast<OUT*>(ebuf + g * kStride) + cl;
      OUT* e1 = reinterpret_cast<OUT*>(ebuf + (g + 8) * kStride) + cl;
      store2(e0, epilogue(acc.d[4 * q], s0, bias0, co),
             epilogue(acc.d[4 * q + 1], s1, bias1, co + 1));
      store2(e1, epilogue(acc.d[4 * q + 2], s0, bias0, co),
             epilogue(acc.d[4 * q + 3], s1, bias1, co + 1));
    }
    __syncwarp();
    constexpr int kPer = 16 / static_cast<int>(sizeof(OUT));
    constexpr int kPpr = kCh / kPer;  // 16-byte pieces a staged row
#pragma unroll
    for (int i = lane; i < 16 * kPpr; i += 32) {
      const int row = i / kPpr;
      const int col = n0 + c0 + (i - row * kPpr) * kPer;
      const int m = wrow + row;
      if (m >= p.m || col >= p.cout) continue;
      const uint8_t* src = ebuf + row * kStride + (i - row * kPpr) * 16;
      OUT* dst = out + static_cast<int64_t>(m) * p.cout + col;
      if (vec && col + kPer <= p.cout) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < kPer && col + e < p.cout; ++e)
          dst[e] = reinterpret_cast<const OUT*>(src)[e];
      }
    }
    __syncwarp();
  }
}

// The two consumer warpgroups (ct = 0..255) of a tile, 64 rows each: for
// each tile, wait for each stage, run its BK / 32 wgmma k-steps on the s32
// sums, release the stage once its products are done (one k-step stays in
// flight), then the epilogue.
template <int BN, int BK, typename OUT>
__device__ __forceinline__ void ws_consume(const ConvArgs& p, const WsSmem& s,
                                           int ct) {
  constexpr int kABytes = kWsBM * BK;
  constexpr int kBBytes = BN * BK;
  const int stages = p.stages;
  const bool resident = p.b_resident != 0;
  const int tiles = p.m_tiles * p.n_tiles;
  const int wg = ct >> 7;              // rows 64 wg .. 64 wg + 63 of a tile
  uint8_t* const ebuf =
      s.smem + s.epi_off + (ct >> 5) * 16 * ws_epi_stride<BN, OUT>();
  if (resident) mbar_wait(s.bars + 16 * stages, 0);
  int stage = 0;
  unsigned phase = 0;
  Acc<BN> acc;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / p.n_tiles) * kWsBM;
    const int n0 = (t - (t / p.n_tiles) * p.n_tiles) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc.d[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < p.k_tiles; ++kt) {
      mbar_wait(s.bars + 8 * stage, phase);
      // the A pieces of the gather came through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      acc_fence(acc);
      wgmma_fence();
      const uint64_t da =
          make_desc<BK>(s.a_s + stage * kABytes + wg * 64 * BK);
      const uint64_t db =
          make_desc<BK>(s.b_s + (resident ? kt : stage) * kBBytes);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      acc_fence(acc);
      wgmma_wait<1>();  // the previous stage's products are done with it
      if (prev >= 0) mbar_arrive(s.bars + 8 * (stages + prev));
      prev = stage;
      if (++stage == stages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    acc_fence(acc);
    mbar_arrive(s.bars + 8 * (stages + prev));
    ws_epilogue<BN, OUT>(p, acc, ebuf, m0, n0, wg, ct);
  }
}

// Barriers: full[s] counts `full_count` arrivals (and the stage's TMA
// bytes), empty[s] the 256 consumer threads, the resident weights' barrier
// one arrival and their bytes.
__device__ __forceinline__ void ws_init_barriers(unsigned bars, int stages,
                                                 unsigned full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, full_count);
      mbar_init(bars + 8 * (stages + s), 256);
    }
    mbar_init(bars + 16 * stages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// All of B (one Cout tile) into shared memory, k_tiles boxes of BN x BK.
template <int BN, int BK>
__device__ __forceinline__ void load_resident_b(const CUtensorMap* wmap,
                                                const ConvArgs& p,
                                                const WsSmem& s) {
  const unsigned bar = s.bars + 16 * p.stages;
  mbar_expect_tx(bar, p.k_tiles * BN * BK);
  for (int kt = 0; kt < p.k_tiles; ++kt)
    tma_load_2d(s.b_s + kt * BN * BK, wmap, bar, kt * BK, 0);
}

// ----- design 1: the input rows gathered by cp.async (any shape with at
// most 64 taps), two producer warpgroups
constexpr int kGatherPW = 2;

template <int BN, typename OUT>
__global__ void __launch_bounds__(ws_threads(kGatherPW), 1)
int8_conv_gather_kernel(const __grid_constant__ CUtensorMap wmap,
                        const ConvArgs p) {
  static_assert(BN <= 128, "the sums of wider tiles need more registers");
  constexpr int PW = kGatherPW;
  constexpr int kProducers = 128 * PW;
  constexpr int kRows = 8 / PW;          // rows a producer thread copies
  constexpr int kBBytes = BN * kWsBK;
  extern __shared__ uint8_t smem_raw[];
  const WsSmem s = ws_smem<BN, kWsBK, OUT>(smem_raw, p);
  const int stages = p.stages;
  const bool resident = p.b_resident != 0;
  // producer threads, and the weights' TMA unless B is resident
  ws_init_barriers(s.bars, stages, kProducers + (resident ? 0 : 1));
  const int tid = threadIdx.x;
  if (tid >= kProducers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        consumer_regs(PW)));
    ws_consume<BN, kWsBK, OUT>(p, s, tid - kProducers);
    return;
  }
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
      producer_regs(PW)));
  if (resident && tid == 0) load_resident_b<BN, kWsBK>(&wmap, p, s);
  const int tiles = p.m_tiles * p.n_tiles;
  const int pc = tid & 7;    // the 16-byte piece of a row this thread copies
  const int r0 = tid >> 3;   // and its rows r0 + 16 PW i
  const int swz = (pc ^ (r0 & 7)) << 4;
  const int hw_out = p.ho * p.wo;
  int stage = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / p.n_tiles) * kWsBM;
    const int n0 = (t - (t / p.n_tiles) * p.n_tiles) * BN;
    // per row: the address of tap (0, 0), channel 0, and a mask of the taps
    // r * kw + c that lie inside the image; rows past M have none
    const int8_t* row_x[kRows];
    uint64_t taps[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + r0 + 16 * PW * i;
      row_x[i] = p.x;
      taps[i] = 0;
      if (m < p.m) {
        const int img = m / hw_out;
        const int rem = m - img * hw_out;
        const int ho = rem / p.wo;
        const int hi0 = ho * p.sh - p.pt;
        const int wi0 = (rem - ho * p.wo) * p.sw - p.pl;
        row_x[i] = p.x +
                   static_cast<int64_t>((img * p.h + hi0) * p.w_ + wi0) * p.cp;
        uint64_t cols = 0;
        for (int c = 0; c < p.kw; ++c)
          if (static_cast<unsigned>(wi0 + c) < static_cast<unsigned>(p.w_))
            cols |= 1ull << c;
        for (int r = 0; r < p.kh; ++r)
          if (static_cast<unsigned>(hi0 + r) < static_cast<unsigned>(p.h))
            taps[i] |= cols << (r * p.kw);
      }
    }
    // this thread's piece of the stage: K offset k, tap (r, c), channel
    // ci, walked 128 bytes a stage
    int k = pc * 16, r = 0, c = 0, ci = pc * 16;
    while (ci >= p.cp) {
      ci -= p.cp;
      if (++c == p.kw) c = 0, ++r;
    }
    for (int kt = 0; kt < p.k_tiles; ++kt) {
      const unsigned full = s.bars + 8 * stage;
      mbar_wait(s.bars + 8 * (stages + stage), phase ^ 1);
      if (!resident && tid == 0) {
        mbar_expect_tx(full, kBBytes);
        tma_load_2d(s.b_s + stage * kBBytes, &wmap, full, kt * kWsBK, n0);
      }
      // the piece's tap bit (none past K) and its offset from tap (0, 0)
      const uint64_t bit = k < p.k ? 1ull << (r * p.kw + c) : 0ull;
      const int off = (r * p.w_ + c) * p.cp + ci;
      const unsigned dst = s.a_s + stage * kWsABytes + r0 * kWsBK + swz;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const bool ok = (taps[i] & bit) != 0;
        cp_async16(dst + 16 * PW * i * kWsBK, ok ? row_x[i] + off : p.x,
                   ok ? 16 : 0);
      }
      cp_async_arrive(full);
      k += kWsBK;
      ci += kWsBK;
      while (ci >= p.cp) {
        ci -= p.cp;
        if (++c == p.kw) c = 0, ++r;
      }
      if (++stage == stages) stage = 0, phase ^= 1;
    }
  }
}

// TMA im2col: the box of 128 output pixels' input at tap (r, c), channels
// [ci, ci + BK), starting from the tile's first pixel (w, h, n).
__device__ __forceinline__ void tma_im2col_4d(unsigned dst,
                                              const CUtensorMap* map,
                                              unsigned bar, int ci, int w,
                                              int h, int n, int c, int r) {
  const unsigned short ow = static_cast<unsigned short>(c);
  const unsigned short oh = static_cast<unsigned short>(r);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(ci), "r"(w),
      "r"(h), "r"(n), "h"(ow), "h"(oh)
      : "memory");
}

// ----- design 2: the input rows by TMA in im2col mode (Cp a multiple of
// BK; the padding and stride in the tensor map)
template <int BN, int BK, typename OUT>
__global__ void __launch_bounds__(ws_threads(1), 1)
int8_conv_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const ConvArgs p) {
  constexpr int kABytes = kWsBM * BK;
  constexpr int kBBytes = BN * BK;
  extern __shared__ uint8_t smem_raw[];
  const WsSmem s = ws_smem<BN, BK, OUT>(smem_raw, p);
  const int stages = p.stages;
  const bool resident = p.b_resident != 0;
  ws_init_barriers(s.bars, stages, 1);  // one thread issues each stage
  const int tid = threadIdx.x;
  if (tid >= 128) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        consumer_regs(1)));
    ws_consume<BN, BK, OUT>(p, s, tid - 128);
    return;
  }
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
      producer_regs(1)));
  if (tid != 0) return;
  if (resident) load_resident_b<BN, BK>(&wmap, p, s);
  const int tiles = p.m_tiles * p.n_tiles;
  const int hw_out = p.ho * p.wo;
  const unsigned stage_bytes = kABytes + (resident ? 0 : kBBytes);
  int stage = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / p.n_tiles) * kWsBM;
    const int n0 = (t - (t / p.n_tiles) * p.n_tiles) * BN;
    const int img = m0 / hw_out;
    const int rem = m0 - img * hw_out;
    const int ho = rem / p.wo;
    const int h0 = ho * p.sh - p.pt;
    const int w0 = (rem - ho * p.wo) * p.sw - p.pl;
    int r = 0, c = 0, ci = 0;  // the stage's tap and channels, walked
    for (int kt = 0; kt < p.k_tiles; ++kt) {
      const unsigned full = s.bars + 8 * stage;
      mbar_wait(s.bars + 8 * (stages + stage), phase ^ 1);
      mbar_expect_tx(full, stage_bytes);
      tma_im2col_4d(s.a_s + stage * kABytes, &xmap, full, ci, w0, h0, img, c,
                    r);
      if (!resident)
        tma_load_2d(s.b_s + stage * kBBytes, &wmap, full, kt * BK, n0);
      if ((ci += BK) == p.cp) {
        ci = 0;
        if (++c == p.kw) c = 0, ++r;
      }
      if (++stage == stages) stage = 0, phase ^= 1;
    }
  }
}

// cuTensorMapEncodeTiled and cuTensorMapEncodeIm2col, looked up in
// libcuda at run time (the build links only the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

void* cuda_entry_point(const char* name) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err =
      cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? ptr
                                                                    : nullptr;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 64 || count[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    if (dev >= 64) return n;
    count[dev] = n;
  }
  return count[dev];
}

// Once per device: the shared memory opt-in, and a check that the kernel
// holds registers enough for setmaxnreg's hand-over (the consumers' raise
// would otherwise wait for ever).
template <int PW, typename K>
cudaError_t ws_setup(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if (attr.numRegs * ws_threads(PW) <
      128 * PW * producer_regs(PW) + 256 * consumer_regs(PW))
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The weights as a (Cout, K) uint8 matrix in boxes of BN rows x BK bytes.
template <int BN, int BK>
bool encode_weights(CUtensorMap* map, const ConvArgs& p) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr)
    encode = reinterpret_cast<EncodeTiled>(
        cuda_entry_point("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k),
                              static_cast<cuuint64_t>(p.cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.k)};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<int8_t*>(p.w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The input codes (N, H, W, Cp) in im2col mode: 128 output pixels a box,
// BK channels of one tap; the bounding box holds the tap-(0, 0) input
// pixel of every output pixel (the padding and stride), out-of-bounds
// pixels read as zero.
template <int BK>
bool encode_input(CUtensorMap* map, const ConvArgs& p) {
  static EncodeIm2col encode = nullptr;
  if (encode == nullptr)
    encode = reinterpret_cast<EncodeIm2col>(
        cuda_entry_point("cuTensorMapEncodeIm2col"));
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(p.cp), static_cast<cuuint64_t>(p.w_),
      static_cast<cuuint64_t>(p.h), static_cast<cuuint64_t>(p.n)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(p.cp),
      static_cast<cuuint64_t>(p.w_) * p.cp,
      static_cast<cuuint64_t>(p.h) * p.w_ * p.cp};
  const int lower[2] = {-p.pl, -p.pt};
  const int upper[2] = {-p.pl + (p.wo - 1) * p.sw - (p.w_ - 1),
                        -p.pt + (p.ho - 1) * p.sh - (p.h - 1)};
  for (int i = 0; i < 2; ++i)
    if (lower[i] < -128 || lower[i] > 127 || upper[i] < -128 || upper[i] > 127)
      return false;
  const cuuint32_t elem[4] = {1, static_cast<cuuint32_t>(p.sw),
                              static_cast<cuuint32_t>(p.sh), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<int8_t*>(p.x), dims, strides, lower, upper, BK,
                kWsBM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tiles of the problem, the grid (at most one block per SM) and the checks
// every wgmma design shares.
template <int BN, int BK, typename OUT>
cudaError_t ws_prepare(ConvArgs& p, int* smem, int* grid) {
  p.n_tiles = (p.cout + BN - 1) / BN;
  p.m_tiles = (p.m + kWsBM - 1) / kWsBM;
  p.k_tiles = (p.k + BK - 1) / BK;
  if (static_cast<int64_t>(p.n_tiles) * p.m_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  *smem = ws_smem_bytes<BN, BK, OUT>(p);
  if (p.stages < 2 || *smem > kSmemLimit || (p.b_resident && p.n_tiles != 1))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int tiles = p.m_tiles * p.n_tiles;
  *grid = tiles < sms ? tiles : sms;
  return cudaSuccess;
}

template <int BN, typename OUT>
cudaError_t launch_gather(ConvArgs p, cudaStream_t stream) {
  static bool done[64] = {};
  if (p.kh * p.kw > 64) return cudaErrorInvalidValue;  // the tap masks
  int smem = 0, grid = 0;
  cudaError_t err = ws_prepare<BN, kWsBK, OUT>(p, &smem, &grid);
  if (err != cudaSuccess) return err;
  auto kernel = int8_conv_gather_kernel<BN, OUT>;
  if ((err = ws_setup<kGatherPW>(kernel, done)) != cudaSuccess) return err;
  CUtensorMap wmap;
  if (!encode_weights<BN, kWsBK>(&wmap, p)) return cudaErrorInvalidValue;
  kernel<<<grid, ws_threads(kGatherPW), smem, stream>>>(wmap, p);
  return cudaGetLastError();
}

template <int BN, int BK, typename OUT>
cudaError_t launch_im2col(ConvArgs p, cudaStream_t stream) {
  static bool done[64] = {};
  if (p.cp % BK) return cudaErrorInvalidValue;
  int smem = 0, grid = 0;
  cudaError_t err = ws_prepare<BN, BK, OUT>(p, &smem, &grid);
  if (err != cudaSuccess) return err;
  auto kernel = int8_conv_tma_kernel<BN, BK, OUT>;
  if ((err = ws_setup<1>(kernel, done)) != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  if (!encode_input<BK>(&xmap, p) || !encode_weights<BN, BK>(&wmap, p))
    return cudaErrorInvalidValue;
  kernel<<<grid, ws_threads(1), smem, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

// design 1 (the gather, tiles up to 128 wide) or 2 (TMA im2col)
template <int BN>
cudaError_t launch_ws(const ConvArgs& p, int design, bool bf16,
                      cudaStream_t stream) {
  if (design == 2) {
    if (p.cp % 128 == 0)
      return bf16 ? launch_im2col<BN, 128, __nv_bfloat16>(p, stream)
                  : launch_im2col<BN, 128, float>(p, stream);
    return bf16 ? launch_im2col<BN, 64, __nv_bfloat16>(p, stream)
                : launch_im2col<BN, 64, float>(p, stream);
  }
  if (design == 1 && BN <= 128) {
    constexpr int kBN = BN <= 128 ? BN : 128;
    return bf16 ? launch_gather<kBN, __nv_bfloat16>(p, stream)
                : launch_gather<kBN, float>(p, stream);
  }
  return cudaErrorInvalidValue;
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

// xq: (N, H, W, Cp) int8, Cp % 16 == 0; wq: (Cout, kh, kw, Cp) int8, read
// as the (Cout, K) matrix; scale, bias: (Cout,) fp32 (bias may be null);
// out: (N, Ho, Wo, Cout), bf16 when out_bf16 else fp32. design 1 gathers
// the input rows with cp.async (kh * kw <= 64, bn <= 128), design 2 reads
// them by TMA in im2col mode (Cp a multiple of 64, corners of the bounding
// box within [-128, 127]); bn in {8, 16, 64, 128, 256} output channels a
// tile, a ring of `stages`; b_resident (Cout <= bn) holds all of the
// weights in shared memory instead of streaming them through the ring. All
// arrays contiguous and 16-byte aligned.
extern "C" int int8_conv2d_forward(const int8_t* xq, const int8_t* wq,
                                   const float* scale, const float* bias,
                                   void* out, int out_bf16, int n, int h,
                                   int w, int cp, int cout, int kh, int kw,
                                   int sh, int sw, int pt, int pl, int ho,
                                   int wo, int design, int bn, int stages,
                                   int b_resident, void* stream) {
  if (cp % 16 || n < 1 || cout < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      ho < 1 || wo < 1 || h >= 0x4000 || w >= 0x4000 || pt >= 0x1000 ||
      pl >= 0x1000 || static_cast<int64_t>(n) * h * w > (1LL << 30) ||
      static_cast<int64_t>(n) * ho * wo > 0x7fffffffLL ||
      static_cast<int64_t>(kh) * kw * cp > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs p{xq, wq, scale, bias, out, n, h, w, cp, cout, kh, kw, sh, sw,
             pt, pl, ho, wo, n * ho * wo, kh * kw * cp, 0, 0, 0, stages,
             b_resident};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = out_bf16 != 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (design == 1 || design == 2) {
    switch (bn) {
      case 8: err = launch_ws<8>(p, design, bf16, s); break;
      case 16: err = launch_ws<16>(p, design, bf16, s); break;
      case 64: err = launch_ws<64>(p, design, bf16, s); break;
      case 128: err = launch_ws<128>(p, design, bf16, s); break;
      case 256: err = launch_ws<256>(p, design, bf16, s); break;
    }
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
