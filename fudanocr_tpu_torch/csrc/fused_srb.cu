// The 3x3 convolutions of the whole TBSRN residual block (SRB) at
// inference, hand-written for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the convolution part of the Pallas TPU kernel
// fudanocr_tpu/ops/fused_srb.py:124 `fused_srb` (pallas_call at :153, body
// `_srb_kernel` :102, convolutions `_conv3x3` :63), and in bf16 also the
// enhancer's qkv projection that the JAX kernel runs on the conv output
// it keeps in VMEM. The rest, attention, its epilogue and the block
// residual, is csrc/fused_enhancer.cu's `fe_attn_epilogue`. The Python
// wrapper, the BN folding, the weight packing and the plain PyTorch
// versions live in fudanocr_tpu_torch/ops/fused_srb.py. One bf16 SRB call
// is three launches:
//   srb_conv3x3_mish_bf16  r1  = bf16(mish(conv3x3(x, W1') + b1'))
//   srb_conv3x3_qkv_bf16   r   = bf16(conv3x3(r1, W2') + b2'),
//                          qkv = bf16(r @ wtop + peqkv[l])     (B, L, 384)
//   fe_attn_epilogue       out = bf16(x + enhancer(r))
// and one fp32 call four: srb_conv3x3 twice (mish, then none), then
// csrc/fused_enhancer.cu's fe_qkv_proj and fe_attn_epilogue.
//
// Layout: the feature map is channels-last (B, H, W, C = 64), i.e. per image
// the row-major (L = H*W, 64) token matrix. Output token r = h*W + w reads
// token r + dy*W + dx where h + dy and w + dx lie inside the image; as a flat
// index that is: r + dy*W + dx in [0, L) and w + dx in [0, W). A tile of R
// output tokens of one image (L is a multiple of 256, so a tile never
// straddles two images) reads three bands of R + 2 tokens, band dy + 1
// starting at flat token r0 + dy*W - 1, zeros outside [0, L) (any W: the
// bands do not depend on it), and masks the W edge per output row and tap.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): per
// conv 2*L*576*64 flops against 2*L*64 elements moved, ~290 flops a byte
// in bf16, at the ridge; conv2 also writes the (L, 384) qkv, so at (256,
// 16, 64, 64) conv1 is bound at 0.020 ms (19.3 GFLOP, 67 MB) and conv2 +
// qkv at 0.080 ms by its 268 MB, 201 MB of them qkv.
//
// What the bf16 design does about it:
//   - persistent blocks, one an SM, each walking over 128-token tiles of
//     all images; its conv's W' (576 x 64, 73,728 B) and, for conv2, wtop
//     (64 x 384, 49,152 B) come once into shared memory by a bulk copy
//     beside the first bands, in the layout wgmma's B descriptor reads
//     (K-major, 128-byte swizzle), packed on the host by ops/fused_srb.py
//     `pack_sw128`;
//   - the bands come by TMA (a 3-D tensor map over (B, L, 64) with the
//     128-byte swizzle), three boxes of 130 tokens a tile whose rows outside
//     the image's [0, L) the hardware fills with zeros, into a ring of two
//     stages: thread 0 asks for tile t + 1's bands as tile t starts;
//   - two consumer warpgroups, 64 output rows each, run 9 taps x 4 k16
//     steps of wgmma.m64n64k16 with A from registers (ldmatrix from the
//     swizzled band at row offset dx + 1, zeroed where the W edge masks the
//     row) and B from the resident W'; the A fragments of tap t + 1 load
//     while tap t's products run;
//   - the epilogue stages each warp's rows in shared memory (the stage's
//     bands, consumed by then: one block barrier) and writes whole 16-byte
//     chunks; conv2 turns its rounded accumulators into A fragments (as
//     flash attention turns P into an A operand) and runs (64 x 64) x
//     (64 x 384) against the resident wtop in three n = 128 chunks of
//     wgmma.m64n128k16, each chunk's peqkv[l] loaded while its products
//     run, added in fp32, rounded once and stored the same way. r never
//     makes the HBM round trip into a separate projection launch.
// Shared memory: conv2 227,328 B + barriers (of 232,448 a block may take),
// conv1 178,176 B; ptxas: 242 and 122 registers, no spills.
// Measured (scripts/time_srb_paths.py; NVIDIA H100 80GB HBM3, 700 W):
// conv1 0.080 ms and conv2 + qkv 0.163 ms at (256, 16, 64, 64), 4.0x and
// 2.0x their bounds.
// Leaving the conv products out takes conv1 only to 0.053, and leaving
// its mish out to 0.043, while a one-exponent mish changes nothing
// (0.079). Tried and slower: a producer warp with the two warpgroups
// decoupled through `empty` mbarriers (conv2 + qkv 0.20 ms), one stage,
// 64-row tiles; no better: conv1's ring three deep, three taps in flight.
//
// fp32 stays on the CUDA cores (tensor-core TF32 would miss the fp32
// tolerance): one block per 128 output tokens, 8x4 FMA register tiles,
// the tap weights staged per tap.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kC = 64;            // channels in and out
constexpr int kQKV = 384;         // the enhancer's q|k|v width

// mish in fp32: v * tanh(softplus(v)), with softplus(v) computed as
// log1p(exp(-|v|)) + max(v, 0)
__device__ __forceinline__ float mish(float v) {
  return v * tanhf(log1pf(expf(-fabsf(v))) + fmaxf(v, 0.f));
}

// ---- fp32: CUDA-core FMAs --------------------------------------------------
// One block per 128 output tokens of one image and all 64 output channels:
// an implicit GEMM (128, 576) x (576, 64) on W' (576, 64), tap (dy+1)*3 +
// (dx+1) in rows [tap*64, tap*64 + 64). Thread (ty, tx) owns output rows
// ty + 16*i (i < 8) and columns tx + 16*j (j < 4). The band row stride 68
// keeps 16-byte rows and puts the two rows a warp reads at once (ty, ty + 1)
// in different banks.
constexpr int kRowsF = 128;
constexpr int kBandF = kRowsF + 2;
constexpr int kThreadsF = 256;
constexpr int kSF = kC + 4;
constexpr int kSmemF32 = (3 * kBandF * kSF + kC * kC) * 4;

__global__ void __launch_bounds__(kThreadsF)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int L, int W, int act_mish) {
  extern __shared__ __align__(16) float smem_f[];
  float* bands = smem_f;
  float* ws = smem_f + 3 * kBandF * kSF;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * kRowsF;
  const size_t img = (size_t)blockIdx.y * L;
  // the three bands, 16-byte copies; tokens outside [0, L) are zeros
  for (int e = tid; e < 3 * kBandF * (kC / 4); e += kThreadsF) {
    const int row = e / (kC / 4), c = (e % (kC / 4)) * 4;
    const int f = r0 + (row / kBandF - 1) * W - 1 + row % kBandF;
    *reinterpret_cast<float4*>(bands + row * kSF + c) =
        f >= 0 && f < L
            ? *reinterpret_cast<const float4*>(x + (img + f) * kC + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // W-edge validity of this thread's rows: bit i for dx = -1 (w > 0), bit
  // 8 + i for dx = +1 (w < W - 1)
  unsigned edge = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int wc = (r0 + ty + 16 * i) % W;
    edge |= (wc > 0 ? 1u : 0u) << i;
    edge |= (wc < W - 1 ? 1u : 0u) << (8 + i);
  }
  float acc[8][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __syncthreads();   // the previous tap's weights are consumed
    for (int e = tid; e < kC * (kC / 4); e += kThreadsF) {
      const int k = e / (kC / 4), c = (e % (kC / 4)) * 4;
      *reinterpret_cast<float4*>(ws + k * kC + c) =
          *reinterpret_cast<const float4*>(w + (size_t)(tap * kC + k) * kC +
                                           c);
    }
    __syncthreads();
    const unsigned ok = dx < 0 ? edge & 0xffu : dx > 0 ? edge >> 8 : 0xffu;
    const float* band = bands + ((dy + 1) * kBandF + ty + dx + 1) * kSF;
#pragma unroll 4
    for (int k = 0; k < kC; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = (ok >> i) & 1u ? band[16 * i * kSF + k] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k * kC + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float v = acc[i][j] + bias[c];
      out[(img + r0 + ty + 16 * i) * kC + c] = act_mish ? mish(v) : v;
    }
}

// ---- bf16: wgmma with TMA-fed bands and resident weights -------------------
constexpr int kWarpgroups = 2;                 // consumer warpgroups a block
constexpr int kRows = 64 * kWarpgroups;        // output tokens a tile
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBandRows = kRows + 2;           // tokens a band (dx = -1..+1)
// a band's bytes, each band 1024-byte aligned (the swizzle's period)
constexpr int kBandBytes = (kBandRows * 128 + 1023) / 1024 * 1024;
constexpr int kStageBytes = 3 * kBandBytes;
constexpr unsigned kStageTx = 3 * kBandRows * 128;   // TMA bytes a stage
constexpr int kWBytes = 9 * kC * kC * 2;       // W', 73,728 B
constexpr int kWtopBytes = kQKV * kC * 2;      // wtop, 49,152 B
constexpr int kStagesMish = 2, kStagesQkv = 2; // ring depth of each conv
// the epilogue's per-warp staging (in the stage's consumed bands): 16 rows
// of r at pitch kSR, or of one 128-column qkv chunk at pitch kSQ (bf16
// elements; the 8-element pads keep the fragment stores conflict-free)
constexpr int kSR = kC + 8;
constexpr int kSQ = 128 + 8;
constexpr int kWarpStage = 16 * kSQ * 2;
static_assert(kThreads / 32 * kWarpStage <= kStageBytes,
              "the staging must fit in one stage");

template <bool QKV, int STAGES>
constexpr int tc_smem_bytes() {
  return 1024 /* alignment slack */ + kWBytes + (QKV ? kWtopBytes : 0) +
         STAGES * kStageBytes + (STAGES + 1) * 8;
}
static_assert(tc_smem_bytes<true, kStagesQkv>() <= 232448,
              "conv2 + qkv exceeds a block's shared memory");
static_assert(tc_smem_bytes<false, kStagesMish>() <= 232448,
              "conv1 exceeds a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// generic-proxy shared-memory writes made visible to the async proxy (TMA,
// wgmma's descriptor reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one TMA box of the (B, L, 64) token map: 64 channels of kBandRows tokens
// from token `l` of image `img` (rows outside [0, L) arrive as zeros)
__device__ __forceinline__ void tma_band(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int l, int img) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(l), "r"(img)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// wgmma's shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: rows of 64 bf16 (128 B), 8-row groups 1024 B apart (SBO); the
// k16 step s starts 32*s bytes into the row
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of r across a wgmma fence/wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// d (64 x 64 fp32, the warpgroup's accumulator) += a (64 x 16 bf16, this
// warp's 16 rows in registers) b (16 x 64 bf16 behind `desc`)
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the same with a 128-column b
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 0;\n"
      "}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef F16
#undef F4

// This warp's 16 rows x 64 columns of the tile's conv, accumulated in acc
// (the m64n64 fragment: acc[4j + h] is row g + 8*(h / 2), column 8j + 2t +
// h % 2). `rows` is the warp's first tile row; ok_* mask the taps that
// cross the W edge for its rows g (lo) and g + 8 (hi).
__device__ __forceinline__ void conv_tile(float (&acc)[32],
                                          const uint8_t* bands,
                                          uint32_t w_addr, int rows, int lane,
                                          bool lo_left, bool hi_left,
                                          bool lo_right, bool hi_right) {
  // ldmatrix.x4: lanes 0-7 / 8-15 / 16-23 / 24-31 give rows 0-7 / 8-15 /
  // 0-7 / 8-15 of the warp's 16, at k 0-7 / 0-7 / 8-15 / 8-15 of the step:
  // registers a0..a3 of the m16n8k16 A layout
  const int lr = rows + (lane & 7) + ((lane >> 3) & 1) * 8, lc = lane >> 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t a[2][4][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3 - 1;
    const int br = lr + dx + 1;
    const uint32_t row = smem_u32(bands + dy * kBandBytes + br * 128);
    uint32_t(&at)[4][4] = a[tap & 1];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4(at[ks], row + ((((2 * ks + lc) ^ br) & 7) << 4));
    const bool ok_lo = dx < 0 ? lo_left : dx > 0 ? lo_right : true;
    const bool ok_hi = dx < 0 ? hi_left : dx > 0 ? hi_right : true;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      at[ks][0] = ok_lo ? at[ks][0] : 0u;
      at[ks][2] = ok_lo ? at[ks][2] : 0u;
      at[ks][1] = ok_hi ? at[ks][1] : 0u;
      at[ks][3] = ok_hi ? at[ks][3] : 0u;
    }
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n64(acc, at[ks], desc_sw128(w_addr + tap * kC * 128 + ks * 32));
    wg_commit();
    wg_wait<1>();   // tap - 1 is done: its A registers may be reloaded
  }
  wg_wait<0>();
  fence_regs(acc);
}

// Copy this warp's 16 staged rows (pitch P elements, N columns) to global
// rows dst + row * ld, columns [0, N), in 16-byte chunks.
template <int P, int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t ld,
                                           const __nv_bfloat16* st,
                                           int lane) {
  constexpr int CH = N / 8;   // 16-byte chunks a row
#pragma unroll
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
        *reinterpret_cast<const uint4*>(st + r * P + c * 8);
  }
}

// QKV = false: out = bf16(mish(conv3x3(x, W') + b')).
// QKV = true:  out = r = bf16(conv3x3(x, W') + b'), and
//              qkv = bf16(r @ wtop + peqkv[l]).
// x comes through `xmap`; wg and wtop_g are the packed (pack_sw128) W' and
// wtop. Each block walks over tiles blockIdx.x, + gridDim.x, ...
template <bool QKV, int STAGES>
__device__ __forceinline__ void srb_conv_tc(
    const CUtensorMap* xmap, const __nv_bfloat16* __restrict__ wg,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ wtop_g,
    const float* __restrict__ peqkv, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* __restrict__ qkv, int L, int W, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ws = smem;                                   // W', packed
  uint8_t* wt = ws + kWBytes;                           // wtop, packed
  uint8_t* ring = wt + (QKV ? kWtopBytes : 0);          // the band stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * kStageBytes);
  uint64_t* wbar = full + STAGES;   // the weights landed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_img = L / kRows;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 loads the j-th tile of this block into stage j % STAGES
  auto issue = [&](int j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= tiles) return;
    const int img = tile / per_img, r0 = (tile % per_img) * kRows;
    uint64_t* bar = &full[j % STAGES];
    uint8_t* dst = ring + (j % STAGES) * kStageBytes;
    mbar_expect_tx(bar, kStageTx);
    for (int dy = 0; dy < 3; ++dy)
      tma_band(dst + dy * kBandBytes, xmap, bar, r0 + (dy - 1) * W - 1, img);
  };
  if (tid == 0) {   // the weights, once a block, beside the first bands
    mbar_expect_tx(wbar, kWBytes + (QKV ? kWtopBytes : 0));
    bulk_load(ws, wg, kWBytes, wbar);
    if (QKV) bulk_load(wt, wtop_g, kWtopBytes, wbar);
    for (int j = 0; j < STAGES - 1; ++j) issue(j);
  }
  const int rows = 16 * warp;   // the warp's first row in the tile
  const uint32_t w_addr = smem_u32(ws);
  mbar_wait(wbar, 0);

  for (int i = 0, tile = blockIdx.x; tile < tiles;
       ++i, tile += gridDim.x) {
    if (tid == 0) issue(i + STAGES - 1);   // its stage was freed last tile
    const int s = i % STAGES;
    const int img = tile / per_img, r0 = (tile % per_img) * kRows;
    uint8_t* bands = ring + s * kStageBytes;
    const int wlo = (r0 + rows + g) % W, whi = (r0 + rows + g + 8) % W;
    mbar_wait(&full[s], (i / STAGES) & 1);
    float acc[32];
    conv_tile(acc, bands, w_addr, rows, lane, wlo > 0, whi > 0, wlo < W - 1,
              whi < W - 1);
    __syncthreads();   // every warp's band reads are done: staging from here
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(
        bands + warp * kWarpStage);
    const size_t row0 = (size_t)img * L + r0 + rows;   // the warp's rows
    uint32_t ra[4][4];   // conv2: r as the A operand of the qkv product
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // b' of this thread's columns 8j + 2t, 8j + 2t + 1
      const float2 bv =
          *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
      float v[4] = {acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y,
                    acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y};
      if (!QKV) {
#pragma unroll
        for (int h = 0; h < 4; ++h) v[h] = mish(v[h]);
      }
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      *reinterpret_cast<uint32_t*>(st + g * kSR + 8 * j + 2 * t) = lo;
      *reinterpret_cast<uint32_t*>(st + (g + 8) * kSR + 8 * j + 2 * t) = hi;
      ra[j / 2][(j & 1) * 2] = lo;
      ra[j / 2][(j & 1) * 2 + 1] = hi;
    }
    __syncwarp();
    store_rows<kSR, kC>(out + row0 * kC, kC, st, lane);
    if (QKV) {
      const float* pq = peqkv + (size_t)(r0 + rows + g) * kQKV + 2 * t;
#pragma unroll
      for (int cc = 0; cc < kQKV / 128; ++cc) {
        // this chunk's peqkv, loaded while its products run
        float2 plo[16], phi[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          plo[j] = *reinterpret_cast<const float2*>(pq + cc * 128 + 8 * j);
          phi[j] = *reinterpret_cast<const float2*>(pq + 8 * kQKV + cc * 128 +
                                                    8 * j);
        }
        float q[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) q[k] = 0.f;
        fence_regs(q);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_n128(q, ra[ks],
                     desc_sw128(smem_u32(wt) + cc * 128 * 128 + ks * 32));
        wg_commit();
        wg_wait<0>();
        fence_regs(q);
        __syncwarp();   // the staged rows were read out (r, or chunk cc - 1)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<uint32_t*>(st + g * kSQ + 8 * j + 2 * t) =
              pack_bf16(q[4 * j] + plo[j].x, q[4 * j + 1] + plo[j].y);
          *reinterpret_cast<uint32_t*>(st + (g + 8) * kSQ + 8 * j + 2 * t) =
              pack_bf16(q[4 * j + 2] + phi[j].x, q[4 * j + 3] + phi[j].y);
        }
        __syncwarp();
        store_rows<kSQ, 128>(qkv + row0 * kQKV + cc * 128, kQKV, st, lane);
      }
    }
    fence_proxy_async();   // the staging writes before the stage's next TMA
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_mish_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __nv_bfloat16* __restrict__ wg,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int L, int W,
                          int tiles) {
  srb_conv_tc<false, kStagesMish>(&xmap, wg, bias, nullptr, nullptr, out,
                                  nullptr, L, W, tiles);
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_qkv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __nv_bfloat16* __restrict__ wg,
                         const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ wtop_g,
                         const float* __restrict__ peqkv,
                         __nv_bfloat16* __restrict__ out,
                         __nv_bfloat16* __restrict__ qkv, int L, int W,
                         int tiles) {
  srb_conv_tc<true, kStagesQkv>(&xmap, wg, bias, wtop_g, peqkv, out, qkv, L,
                                W, tiles);
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The bands' tensor map over x (B, L, 64) bf16: boxes of 64 channels x
// kBandRows tokens x 1 image, the 128-byte swizzle, zeros out of bounds.
// Returns 0, or the CUDA error to report.
int band_map(CUtensorMap* map, const void* x, int B, int L) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {kC, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {kC * 2, (cuuint64_t)L * kC * 2};
  const cuuint32_t box[3] = {kC, kBandRows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launch's grid: one persistent block an SM, no more than the tiles.
int tc_grid(int tiles, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = tiles < sms ? tiles : sms;
  return (int)e;
}

}  // namespace

// out = act(conv3x3(x, W') + b') over B channels-last (H, W, 64) fp32 maps,
// act mish when `mish` is nonzero, else the identity. x and out (B, H*W,
// 64), contiguous and 16-byte aligned, W' (576, 64), b' (64). H*W must be a
// positive multiple of 128 (the SRB gate admits multiples of 256). Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int srb_conv3x3(const void* x, const void* w, const void* b,
                           void* out, int B, int H, int W, int mish,
                           void* stream) {
  const int L = H * W;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || L % kRowsF)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemF32);
  if (err != cudaSuccess) return (int)err;
  conv3x3_fma_kernel<<<dim3(L / kRowsF, B), kThreadsF, kSmemF32,
                       (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out, L, W,
      mish);
  return (int)cudaGetLastError();
}

// bf16, conv1 of the block: out = bf16(mish(conv3x3(x, W') + b')). x and
// out (B, H*W, 64) bf16, contiguous and 16-byte aligned; wg the packed W'
// (ops/fused_srb.py `pack_sw128` of the (576, 64) W'), b' (64) fp32. H*W
// must be a positive multiple of 128. Returns the CUDA error of the tensor
// map's encoding or of the launch (0 = success).
extern "C" int srb_conv3x3_mish_bf16(const void* x, const void* wg,
                                     const void* b, void* out, int B, int H,
                                     int W, void* stream) {
  const int L = H * W;
  if (B < 1 || H < 1 || W < 1 || L % kRows) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = band_map(&map, x, B, L);
  const int tiles = B * (L / kRows);
  int grid = 0;
  if (!err) err = tc_grid(tiles, &grid);
  if (err) return err;
  constexpr int bytes = tc_smem_bytes<false, kStagesMish>();
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_mish_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  conv3x3_mish_wgmma_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      map, (const __nv_bfloat16*)wg, (const float*)b, (__nv_bfloat16*)out, L,
      W, tiles);
  return (int)cudaGetLastError();
}

// bf16, conv2 of the block and the enhancer's qkv projection: out = r =
// bf16(conv3x3(x, W') + b') (B, H*W, 64) and qkv = bf16(r @ wtop +
// peqkv[l]) (B, H*W, 384), both bf16 and contiguous; wtop_g the packed
// (pack_sw128) (64, 384) wtop, peqkv (H*W, 384) fp32; the rest as
// srb_conv3x3_mish_bf16.
extern "C" int srb_conv3x3_qkv_bf16(const void* x, const void* wg,
                                    const void* b, const void* wtop_g,
                                    const void* peqkv, void* out, void* qkv,
                                    int B, int H, int W, void* stream) {
  const int L = H * W;
  if (B < 1 || H < 1 || W < 1 || L % kRows) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = band_map(&map, x, B, L);
  const int tiles = B * (L / kRows);
  int grid = 0;
  if (!err) err = tc_grid(tiles, &grid);
  if (err) return err;
  constexpr int bytes = tc_smem_bytes<true, kStagesQkv>();
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_qkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  conv3x3_qkv_wgmma_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      map, (const __nv_bfloat16*)wg, (const float*)b,
      (const __nv_bfloat16*)wtop_g, (const float*)peqkv, (__nv_bfloat16*)out,
      (__nv_bfloat16*)qkv, L, W, tiles);
  return (int)cudaGetLastError();
}
