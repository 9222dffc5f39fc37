// The whole TBSRN FeatureEnhancer at inference, hand-written for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel fudanocr_tpu/ops/fused_enhancer.py:188
// `fused_enhancer` (pallas_call at :211, body `enhancer_body` :75-149).
// The Python wrapper and the plain PyTorch version of the same math live in
// fudanocr_tpu_torch/ops/fused_enhancer.py.
//
// Per image, for (L, 64) raw tokens t and the (L, 64) 2D positional code:
//   x   = [t | pe]                                   (L, 128)
//   qkv = t @ Wqkv[:64] + peqkv,  peqkv = pe @ Wqkv[64:] + b  (batch constant,
//         computed once by the wrapper)
//   attn = softmax(q k^T / sqrt(dh)) v  per head    (4 heads of 32, or 2 of 64)
//   x1 = LN1(x + attn @ Wout + bout)
//   x2 = LN2(x1 + relu(x1 @ W1 + b1) @ W2 + b2)
//   out = x2 @ Wp + bp                               (L, 64)
// LN is the reference's (v - mean) / (unbiased std + eps) * g + b.
// Accumulation is fp32 throughout; values round to the compute type T at
// the same sublayer boundaries as the JAX kernel and the plain version
// (qkv, attn, out, x1, relu output, y, x2, out).
//
// Two launches:
//   (a) fe_qkv_proj: (B*L, 64) @ (64, 384) + peqkv[l] into a (B, L, 384)
//       scratch buffer the wrapper allocates.
//   (b) fe_attn_epilogue: one block per (64-row q tile, image). Per head, an
//       online-softmax loop over K/V tiles (64 keys in bf16, 32 in fp32)
//       with a true per-row max;
//       then, on the tile held in shared memory, out-proj, residual, LN1,
//       FFN, LN2 and the 64-d projection. Only (B, L, 64) is written.
// K and V of one image at L=1024 are 256 KB each in bf16, more than the
// 227 KB of shared memory a block may hold, hence the K/V tiling.
//
// What bounds it on this card: per image and enhancer about 0.70 GFLOP
// (2*L*(64*384 + 4*2*L*32 + 3*128^2 + 128*64) at L=1024, three quarters of
// it attention) against ~0.26 MB of essential bf16 token traffic plus
// 0.75 MB for the qkv scratch round trip: far above the ~295 flop/byte
// ridge, so it is compute-bound in the attention.
//
// What the design does about it, in bf16: every product (qkv, QK^T, PV,
// out-proj, FFN, proj) runs on the tensor cores through mma.sync m16n8k16
// with fp32 accumulators, the online softmax working on the accumulator
// fragments; B fragments come through ldmatrix.trans. (b) keeps the tensor
// cores fed with the loop of csrc/unmasked_attention.cu's
// attn_fwd_mma_kernel:
//   - the 64-key K and V tiles of all heads (34,816 B a tile pair) are
//     double-buffered with 16-byte cp.async copies: one barrier per tile,
//     tile j + 1 in flight while tile j computes; the q tile first sits in
//     stage 1 and gives it up once its fragments are in registers;
//   - every shared tile is bf16 (the values are rounded to bf16 before
//     they are stored anyway), so after the loop the two stages hold the
//     working tile, x1 and one whole staged weight: 69,632 B of shared
//     memory a block for the whole kernel;
//   - the epilogue's weights are cp.async copies too, each issued as soon
//     as the product before it is done with the stage (Wout during the
//     last K/V tile), so they land during the stores and LayerNorms;
//   - __launch_bounds__(256, 2) holds it to 128 registers a thread, so 2
//     blocks (16 warps) share an SM: the registers, not the shared memory
//     (3 blocks would fit), bound the blocks per SM. ptxas (nvcc 12.8,
//     sm_90a; scripts/time_fused_enhancer.py --ptxas) gives <bf16, 32> 128
//     registers with 16 bytes spilled, <bf16, 64> 126 and no spill.
//     Without the bound (1 block an SM) (b) takes 1.64 ms at (256, 1024)
//     instead of 1.23-1.24 (scripts/time_fused_enhancer.py --variants;
//     NVIDIA H100 80GB HBM3, 700 W).
// What bounds (b) now: the attention loop alone takes 0.99-1.00 ms of
// those 1.23-1.24 (about 140 TFLOP/s; the same script), on mma.sync and
// on the instructions of the online softmax per score (scale, max,
// subtract, exp, sum, pack); wgmma, TMA and warp specialisation are later
// work. (a) stages the whole (64, 384) weight and 128 token rows per
// block (68,608 B, 80 registers, 3 blocks an SM) and writes each warp's
// rows through shared memory as whole 16-byte chunks; the (B, L, 384)
// scratch it writes sets its bound (~0.07 ms of bytes at B 256).
//
// In fp32 every product runs on the tensor cores in split TF32 (3xTF32):
// each operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and a product
// of 8 columns is hi hi + hi lo + lo hi in three mma.sync m16n8k8 TF32
// steps with fp32 accumulators (csrc/tf32x3.cuh). One TF32 product would
// miss the fp32 bar (rtol 2e-4, atol 2e-5) by 72-95x; three stay at
// 0.25-0.37 of it (tests/test_torch_enhancer_tf32x3_rounding.py, a CPU
// model of these kernels' rounding against the JAX kernel).
// What bounds fp32: 4.51e10 flops at (64, 1024), three TF32 products each
// at 495 TFLOP/s, 0.2733 ms (the CUDA cores' fp32 floor, 0.6731 ms, is what
// the earlier CUDA-core kernels could not go below); the bytes, with the
// (B, L, 384) fp32 scratch, take ~0.07 ms.
// What the design does about it:
//   - (b) runs 16 warps a block (512 threads, __launch_bounds__(512, 1),
//     so at most 128 registers a thread), one block an SM: warp w owns 16
//     q rows and 32 output columns, so a head of 32 (or half a head of 64,
//     whose Q K^T the two warps then both compute) needs no more registers
//     than one warp's split q operand, its scores and two running sums.
//     Two blocks of 8 warps would need 64 output columns a warp, twice
//     the registers, or 32-row q tiles that read every image's K and V
//     from L2 twice as often;
//   - a K/V tile is 64 keys of every head. It lands raw by 16-byte
//     cp.async copies in a landing stage (67,584 B), and is split from
//     there once into TF32 hi and lo in a working stage (135,168 B), so no
//     warp splits a B fragment of Q K^T or P V; the next tile lands while
//     this one is computed. The warps of one head (4 at DH 32, 8 at DH 64)
//     copy, split and read only that head's columns and wait only for
//     each other, two named barriers a tile (landed; split), so the heads'
//     groups run out of step and one group's copies, split and barriers
//     overlap the others' products: 1.0639-1.0647 ms of device time at
//     (64, 1024) against 1.2048-1.2072 with the whole block in step (one
//     call; scripts/time_fused_enhancer.py, NVIDIA H100 80GB HBM3, 700 W;
//     64-key tiles had taken 1.2089 against 32-key tiles' 1.2875).
//     Splitting at each fragment load instead (the raw tiles double-
//     buffered, one barrier a tile; the script's fp32_split_at_load)
//     takes 1.1674-1.1720 against 1.0663 in one call: the split's
//     instructions, repeated by the 4 row groups, cost more than the
//     second barrier and the split pass. The q fragments are split once
//     into registers;
//   - P reaches the P V product as the A operand straight from the score
//     accumulators (mma3_xb: the A layout holds columns t and t + 4 where
//     the accumulator holds 2t and 2t + 1, so the 8 columns are
//     relabelled, which a sum over them allows);
//   - the epilogue's four products split their A fragments as they load
//     them and each weight value as they read it (a staged weight's hi and
//     lo would not fit beside the working tiles); the weights are cp.async
//     copies issued as soon as the product before is done with the
//     region (Wout once every warp is done with the K/V tiles, into the
//     landing stage). The working stage then holds the working tile and
//     x1, and the landing stage (2 KB longer) one whole weight: 204,800 B
//     a block. The LayerNorms stay fp32 on the CUDA cores;
//   - (a) stages the whole (64, 384) weight (100,352 B, 2 blocks an SM);
//     each warp splits its 16 token rows once and writes its results from
//     the fragments as 8-byte pairs, 32 whole bytes of a row a quad.
//   ptxas (nvcc 12.8, sm_90a; scripts/time_fused_enhancer.py --ptxas):
//   attn_epilogue_tf32x3_kernel<32> 128 registers, no spill; <64> 128
//   registers, 180 bytes of spill stores (the head's 64-wide q operand);
//   qkv_proj_tf32x3_kernel 127 registers, no spill.
// What bounds fp32 now: (b) is at 4.2x its bound (0.254 ms, its products)
// and (a) at 2.5x its own (0.036 ms, its bytes, the fp32 scratch most).
// (b)'s attention loop alone takes 0.809-0.816 of its 1.066 ms (the
// variant that returns after it), the seg forward 0.738 on the same
// attention (csrc/unmasked_attention_fwd_tf32x3.cu at (64, 1024, 384)),
// whose blocks each split one head's K and V for 128 q rows, half the
// splitting per product of this kernel's 64 rows; the epilogue's four
// products and two LayerNorms take the other ~0.25. __expf in place of
// expf takes 1-2 % off (1.0445-1.0571).
//
// Unlike the TPU kernel it keeps the per-row softmax max (no +-100 clip),
// uses expf (__expf in bf16), and scales the fp32 scores rather than q
// before its cast. In bf16 the probabilities are rounded to bf16 for the
// PV product (as the JAX kernel does); the plain version keeps them fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kD = 128;        // model width: 64 token + 64 PE channels
constexpr int kC = 64;         // token channels in and out
constexpr int kQKV = 3 * kD;   // fused q|k|v width
constexpr int kT = 64;         // rows per q tile and per k/v tile
constexpr int kThreads = 256;  // 8 warps (bf16 kernels, fp32 qkv)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round an fp32 value to the compute type and back
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc (16 x NT*8) += the k-step (ah, al) of A times 8 rows of a row-major
// fp32 weight in shared memory (w: row t, column g of the first n-tile;
// pitch SW), each B value split into TF32 hi + lo as it is read; per
// n-tile three products, lo hi, hi lo, hi hi (tests/
// test_torch_enhancer_tf32x3_rounding.py models this order)
template <int NT, int SW>
__device__ __forceinline__ void mma3_kstep(float (&acc)[NT][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float* w) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t h0, l0, h1, l1;
    split_tf32(w[n * 8], h0, l0);
    split_tf32(w[4 * SW + n * 8], h1, l1);
    mma_tf32(acc[n], al, h0, h1);
    mma_tf32(acc[n], ah, l0, l1);
    mma_tf32(acc[n], ah, h0, h1);
  }
}

// ---------------------------------------------------------------- (a) qkv
// bf16: mma.sync m16n8k16. One block per 128 rows: the whole (64, 384)
// weight and the block's token rows are staged with cp.async copies (rows
// past the end as zeros); warp w owns rows w*16..+15 and computes them 128
// columns at a time, adds the PE term, and writes the bf16 results through
// its own 16 shared staging rows, so that the scratch buffer gets whole
// 16-byte chunks, each half warp one 256-byte row segment.
constexpr int kQRows = 128;          // rows per block
constexpr int kQSX = kC + 8;         // bf16 pitch of the token rows
constexpr int kQSW = kQKV + 8;       // ... of the staged weight
constexpr int kQkvSmemBytes =
    (int)sizeof(__nv_bfloat16) * (kC * kQSW + kQRows * kQSX);   // 68,608

__global__ void __launch_bounds__(kThreads, 3)
qkv_proj_mma_kernel(const __nv_bfloat16* __restrict__ tokens,
                    const __nv_bfloat16* __restrict__ wtop,
                    const float* __restrict__ peqkv,
                    __nv_bfloat16* __restrict__ qkv, int rows, int L) {
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ws + kC * kQSW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kQRows, n = min(kQRows, rows - row0);
  copy_rows<kQKV, true, kThreads>(ws, wtop, kQKV, kC);
  copy_rows<kC, true, kThreads>(xs, tokens + (size_t)row0 * kC, kC, n);
  for (int e = n * (kC / 8) + threadIdx.x; e < kQRows * kC / 8;
       e += kThreads)
    *reinterpret_cast<uint4*>(xs + e / (kC / 8) * kQSX + e % (kC / 8) * 8) =
        make_uint4(0, 0, 0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16;
  __nv_bfloat16* ow = xs + r0 * kQSX;   // this warp's rows, then its staging
  uint32_t af[kC / 16][4];
#pragma unroll
  for (int ks = 0; ks < kC / 16; ++ks) {
    const __nv_bfloat16* a = ow + g * kQSX + ks * 16 + 2 * t;
    af[ks][0] = ld32(a);
    af[ks][1] = ld32(a + 8 * kQSX);
    af[ks][2] = ld32(a + 8);
    af[ks][3] = ld32(a + 8 * kQSX + 8);
  }
  __syncwarp();   // the rows are in registers; they become the staging
  for (int cc = 0; cc < kQKV; cc += kC) {
    float acc[kC / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks)
#pragma unroll
      for (int nn = 0; nn < kC / 8; nn += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * kQSW + cc +
                                 nn * 8 + (lane >> 4) * 8);
        mma_bf16(acc[nn], af[ks], b[0], b[1]);
        mma_bf16(acc[nn + 1], af[ks], b[2], b[3]);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr;
      const float* pq =
          peqkv + (size_t)((row0 + r0 + r) % L) * kQKV + cc + 2 * t;
#pragma unroll
      for (int nn = 0; nn < kC / 8; ++nn)
        *reinterpret_cast<uint32_t*>(ow + r * kQSX + nn * 8 + 2 * t) =
            pack_bf16(acc[nn][2 * hr] + pq[nn * 8],
                      acc[nn][2 * hr + 1] + pq[nn * 8 + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (kC / 8); i += 32) {
      const int r = i / (kC / 8), c = i % (kC / 8);
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(qkv + (size_t)(row0 + r0 + r) * kQKV + cc +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(ow + r * kQSX + c * 8);
    }
    __syncwarp();   // the staging rows are read before the next columns
  }
}

// fp32: split TF32 on the tensor cores through mma.sync m16n8k8. One block
// per 128 rows: the whole (64, 384) weight is staged with cp.async copies
// (pitch kQKV + 8, free of bank conflicts for the B fragments, each split
// into TF32 hi + lo as it is read); warp w owns rows w*16..+15, whose
// tokens it reads and splits once into registers (rows past the end as
// zeros), and computes them 64 columns at a time, three products a k-step
// (lo hi, hi lo, hi hi). Each value gets its fp32 PE term and is stored
// from the fragments as an 8-byte pair: a quad writes 32 whole bytes of a
// row. 100,352 B of shared memory, 2 blocks an SM.
constexpr int kQSWF = kQKV + 8;   // fp32 pitch of the staged weight
constexpr int kQkvF32SmemBytes = (int)sizeof(float) * kC * kQSWF;

__global__ void __launch_bounds__(kThreads, 2)
qkv_proj_tf32x3_kernel(const float* __restrict__ tokens,
                       const float* __restrict__ wtop,
                       const float* __restrict__ peqkv,
                       float* __restrict__ qkv, int rows, int L) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int e = threadIdx.x; e < kC * kQKV / 4; e += kThreads) {
    const int r = e / (kQKV / 4), c = e % (kQKV / 4);
    cp_async16(smem + r * kQSWF + c * 4, wtop + (size_t)r * kQKV + c * 4);
  }
  cp_async_commit();
  const int row = blockIdx.x * kQRows + warp * 16;   // this warp's row 0
  AOperand<kC / 8> a;
  {
    const int ra = row + g, rb = ra + 8;
    const float* pa = tokens + (size_t)ra * kC + t;
    const float* pb = pa + 8 * kC;
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk) {
      split_tf32(ra < rows ? pa[kk * 8] : 0.f, a.h[kk][0], a.l[kk][0]);
      split_tf32(rb < rows ? pb[kk * 8] : 0.f, a.h[kk][1], a.l[kk][1]);
      split_tf32(ra < rows ? pa[kk * 8 + 4] : 0.f, a.h[kk][2], a.l[kk][2]);
      split_tf32(rb < rows ? pb[kk * 8 + 4] : 0.f, a.h[kk][3], a.l[kk][3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int cc = 0; cc < kQKV; cc += kC) {
    float acc[kC / 8][4];
#pragma unroll
    for (int n = 0; n < kC / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kC / 8; ++ks)
      mma3_kstep<kC / 8, kQSWF>(acc, a.h[ks], a.l[ks],
                                smem + (ks * 8 + t) * kQSWF + cc + g);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row + g + 8 * hr;
      if (r >= rows) continue;
      const float* pq = peqkv + (size_t)(r % L) * kQKV + cc + 2 * t;
      float* dst = qkv + (size_t)r * kQKV + cc + 2 * t;
#pragma unroll
      for (int n = 0; n < kC / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(acc[n][2 * hr] + pq[n * 8],
                        acc[n][2 * hr + 1] + pq[n * 8 + 1]);
    }
  }
}

// ------------------------------------------------- (b) attention + epilogue

// Row-wise LN over the 128 columns of shared tiles of element type Buf
// (float, or bf16 in the tensor-core path) and row pitch P, one warp per
// row: dst[r] = round(LN(a[r] + b[r])). `a` is either a shared tile or,
// when x_tokens is set, the tokens-with-PE row read from global memory.
template <typename T, typename Buf, int P, int WARPS = kThreads / 32>
__device__ __forceinline__ void layer_norm_rows(
    const T* __restrict__ x_tokens, const T* __restrict__ pe, const Buf* a,
    const Buf* b, const float* __restrict__ g, const float* __restrict__ beta,
    float eps, Buf* dst, Buf* dst2, int q0, int L, size_t tok_base) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kT; r += WARPS) {
    const int l = q0 + r;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      float xa;
      if (x_tokens != nullptr) {
        xa = l < L ? (c < kC ? to_f(x_tokens[tok_base + (size_t)r * kC + c])
                             : to_f(pe[(size_t)l * kC + c - kC]))
                   : 0.f;
      } else {
        xa = to_f(a[r * P + c]);
      }
      v[q] = xa + to_f(b[r * P + c]);
    }
    const float mean = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.f / kD);
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] -= mean;
      ss += v[q] * v[q];
    }
    const float denom = sqrtf(warp_sum(ss) / (kD - 1)) + eps;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      const Buf y = from_f<Buf>(rnd<T>(v[q] / denom * g[c] + beta[c]));
      dst[r * P + c] = y;
      if (dst2 != nullptr) dst2[r * P + c] = y;
    }
  }
}

// ---- bf16: tensor cores through mma.sync m16n8k16 (design at the top) -----
// Every tile is bf16 at row pitch kP: the pad keeps the fragment loads
// (32-bit K loads, ldmatrix.trans of V and of the weights) free of bank
// conflicts. Shared memory is two stages of [K tile | V tile]; the q tile
// first sits in stage 1. After the K/V loop the stage of the last tile
// holds bufA and bufB, and the other one the staged weight.
constexpr int kP = kD + 8;                // bf16 row pitch of the tiles
constexpr int kTile16 = kT * kP;          // a (64, 128) tile, in elements
constexpr int kStage = 2 * kTile16;       // a K tile and a V tile
constexpr int kMmaSmemBytes =
    2 * kStage * (int)sizeof(__nv_bfloat16);   // 69,632
static_assert(kD * kP <= kStage, "a (128, 128) weight fits one stage");

// `rows` rows of one 128-wide part of qkv (row stride kQKV) from src into
// the (64, 128) tile dst with 16-byte cp.async copies; rows from `rows` to
// 63 (past L) are stored as zeros: cp.async must not read past the image
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int rows) {
  copy_rows<kD, true, kThreads>(dst, src, kQKV, rows);
  for (int e = rows * (kD / 8) + threadIdx.x; e < kT * kD / 8; e += kThreads)
    *reinterpret_cast<uint4*>(dst + e / (kD / 8) * kP + e % (kD / 8) * 8) =
        make_uint4(0, 0, 0, 0);
}

// Attention of this block's 64 q rows over the image's L keys, every head.
// Warp w owns q rows (w%4)*16..+15 and heads w/4, w/4+2, ...: QK^T and PV
// run as bf16 mma with fp32 accumulators, the online softmax with a true
// per-row max on the accumulator fragments (a row's values sit in the 4
// lanes of a quad). The scores are scaled in fp32 (rounded once, not
// contracted into the exponent's argument) before __expf, whose error is
// far below bf16's; P is rounded to bf16 for the PV product, its row sums
// stay fp32; o / l is rounded to bf16 once, into bufA.
//
// The K/V tiles (64 keys of every head) are double-buffered with cp.async:
// one barrier per tile, after which tile j is in and every warp is done
// with tile j - 1 (at j = 0, with the q tile), so tile j + 1 loads into
// that stage while tile j is computed. During the last tile the free stage
// takes Wout, the first weight of the epilogue (its copies stay in flight
// past the return). A ragged last tile (L % 64) has zero rows and its
// scores past L masked to -inf.
template <int DH>
__device__ __forceinline__ void attention_mma(
    const __nv_bfloat16* __restrict__ qkv, size_t img, int q0, int L,
    __nv_bfloat16* smem, const __nv_bfloat16* __restrict__ wout,
    __nv_bfloat16* ws, __nv_bfloat16* bufA) {
  constexpr int kHeads = kD / DH;
  constexpr int HPW = kHeads / 2;   // heads per warp (8 warps, 4 row groups)
  constexpr int KS = DH / 16;       // k-steps of the QK^T product
  constexpr int NO = DH / 8;        // n-tiles of the PV product
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma group and lane in it
  const int r0 = (warp & 3) * 16, hsel = warp >> 2;
  const float scale = 1.f / sqrtf((float)DH);
  const int tiles = (L + kT - 1) / kT;
  const __nv_bfloat16* rows0 = qkv + img * kQKV;   // row 0 of this image
  auto load_kv = [&](int j) {
    const int k0 = j * kT, n = min(kT, L - k0);
    __nv_bfloat16* st = smem + (j & 1) * kStage;
    stage_rows(st, rows0 + (size_t)k0 * kQKV + kD, n);
    stage_rows(st + kTile16, rows0 + (size_t)k0 * kQKV + 2 * kD, n);
  };

  __nv_bfloat16* qs = smem + kStage;
  stage_rows(qs, rows0 + (size_t)q0 * kQKV, min(kT, L - q0));
  cp_async_commit();
  load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();   // the q tile is in, from this thread's copies
  __syncthreads();
  uint32_t qa[HPW][KS][4];
  float o[HPW][NO][4], m[HPW][2], l[HPW][2];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = hsel + 2 * i;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const __nv_bfloat16* q = qs + (r0 + g) * kP + h * DH + k * 16 + 2 * t;
      qa[i][k][0] = ld32(q);
      qa[i][k][1] = ld32(q + 8 * kP);
      qa[i][k][2] = ld32(q + 8);
      qa[i][k][3] = ld32(q + 8 * kP + 8);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][n][c] = 0.f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
  }

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();   // tile j is in, from this thread's copies
    __syncthreads();
    if (j + 1 < tiles)
      load_kv(j + 1);
    else
      copy_rows<kD, true, kThreads>(ws, wout, kD, kD);
    cp_async_commit();
    const int k0 = j * kT;
    const bool ragged = k0 + kT > L;
    const __nv_bfloat16* ks = smem + (j & 1) * kStage;
    const __nv_bfloat16* vs = ks + kTile16;
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int h = hsel + 2 * i;
      float s[kT / 8][4];
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const __nv_bfloat16* kp =
              ks + (n * 8 + g) * kP + h * DH + k * 16 + 2 * t;
          mma_bf16(s[n], qa[i][k], ld32(kp), ld32(kp + 8));
        }
      }
      // this lane holds rows g (c = 0, 1) and g + 8 (c = 2, 3), key
      // columns n*8 + 2t + {0, 1}
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kT / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = __fmul_rn(s[n][c], scale);
          if (ragged && k0 + n * 8 + 2 * t + (c & 1) >= L)
            s[n][c] = -INFINITY;
          mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        // key k0 is valid in every tile, so this is finite
        const float m_new = fmaxf(m[i][rr], mx[rr]);
        alpha[rr] = __expf(m[i][rr] - m_new);   // 0 on the first tile
        m[i][rr] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kT / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = __expf(s[n][c] - m[i][c >> 1]);
          sum[c >> 1] += s[n][c];
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
        sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
        l[i][rr] = l[i][rr] * alpha[rr] + sum[rr];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][n][c] *= alpha[c >> 1];
      // O += bf16(P) V: the accumulators of key n-tiles 2kk, 2kk + 1 are
      // the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kk * 16 + (lane & 15)) * kP + h * DH +
                                   n * 8 + (lane >> 4) * 8);
          mma_bf16(o[i][n], pa, b[0], b[1]);
          mma_bf16(o[i][n + 1], pa, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();   // every warp is done with the last tile's stage (bufA)
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = hsel + 2 * i;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(bufA + (r0 + g + 8 * hr) * kP + h * DH +
                                     n * 8 + 2 * t) =
            pack_bf16(o[i][n][2 * hr] / l[i][hr],
                      o[i][n][2 * hr + 1] / l[i][hr]);
  }
}

// out = in @ W for the (64, 128) bf16 tile `in` and a row-major (128, N)
// weight whose cp.async copies into ws (pitch N + 8) are committed. Warp w
// owns rows (w%4)*16..+15 and the column half w/4; A fragments are 32-bit
// loads of `in`, B fragments ldmatrix.trans of ws. Waits for the copies,
// runs the products, and once every warp is done reading `in` and ws,
// commits the copies of the next weight `next` ((128, NN); none when null)
// into ws, so that they land during the stores and the LayerNorm after
// them; then calls store(row, col, v0, v1) for columns col, col + 1, which
// may overwrite `in`.
template <int N, int NN, typename Store>
__device__ __forceinline__ void tile_matmul_mma(
    const __nv_bfloat16* in, __nv_bfloat16* ws,
    const __nv_bfloat16* __restrict__ next, Store store) {
  constexpr int NT = N / 16;   // n-tiles of 8 per warp (half the columns)
  constexpr int SW = N + 8;    // row pitch of the staged W
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * (N / 2);
  cp_async_wait<0>();
  __syncthreads();   // W is in from every thread's copies; `in` is written
  float acc[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const __nv_bfloat16* a = in + (r0 + g) * kP + ks * 16 + 2 * t;
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * kP), ld32(a + 8),
                            ld32(a + 8 * kP + 8)};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * SW + c0 + n * 8 +
                               (lane >> 4) * 8);
      mma_bf16(acc[n], af, b[0], b[1]);
      mma_bf16(acc[n + 1], af, b[2], b[3]);
    }
  }
  __syncthreads();   // every warp is done reading `in` and ws
  if (next != nullptr) {
    copy_rows<NN, true, kThreads>(ws, next, NN, kD);
    cp_async_commit();
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      store(r0 + g + 8 * hr, c0 + n * 8 + 2 * t, acc[n][2 * hr],
            acc[n][2 * hr + 1]);
}

// T(v0), T(v1) into two adjacent bf16 slots
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}

// bf16: at most 128 registers a thread, so that two blocks fit an SM
constexpr int kMinBlocks = 2;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attn_epilogue_kernel(const T* __restrict__ qkv, const T* __restrict__ tokens,
                     const T* __restrict__ pe, const T* __restrict__ wout,
                     const float* __restrict__ bout,
                     const float* __restrict__ ln1s,
                     const float* __restrict__ ln1b, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ ln2s,
                     const float* __restrict__ ln2b, const T* __restrict__ wp,
                     const float* __restrict__ bp, const T* __restrict__ res,
                     T* __restrict__ out, int L, float eps) {
  static_assert(std::is_same<T, __nv_bfloat16>::value,
                "fp32 runs attn_epilogue_tf32x3_kernel");
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * kT;
  const size_t img = (size_t)blockIdx.y * L;   // first row of this image

  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tiles = (L + kT - 1) / kT;
  // the weights take the stage that the last K/V tile leaves free, the
  // working tiles the other one
  __nv_bfloat16* ws = sm + (tiles & 1) * kStage;
  __nv_bfloat16* bufA = sm + ((tiles - 1) & 1) * kStage;
  __nv_bfloat16* bufB = bufA + kTile16;   // x1, kept for the 2nd residual
  attention_mma<DH>(qkv, img, q0, L, sm, wout, ws, bufA);
  // out = attn @ Wout + bout, in place in bufA
  tile_matmul_mma<kD, kD>(bufA, ws, w1, [&](int r, int c, float v0,
                                            float v1) {
    store2(bufA + r * kP + c, v0 + bout[c], v1 + bout[c + 1]);
  });
  __syncthreads();
  // x1 = LN1(x + out) into bufA and bufB
  layer_norm_rows<T, __nv_bfloat16, kP>(tokens, pe, nullptr, bufA, ln1s,
                                        ln1b, eps, bufA, bufB, q0, L,
                                        (img + q0) * kC);
  // relu(x1 @ W1 + b1)
  tile_matmul_mma<kD, kD>(bufA, ws, w2, [&](int r, int c, float v0,
                                            float v1) {
    store2(bufA + r * kP + c, fmaxf(v0 + b1[c], 0.f),
           fmaxf(v1 + b1[c + 1], 0.f));
  });
  // y = h @ W2 + b2
  tile_matmul_mma<kD, kC>(bufA, ws, wp, [&](int r, int c, float v0,
                                            float v1) {
    store2(bufA + r * kP + c, v0 + b2[c], v1 + b2[c + 1]);
  });
  __syncthreads();
  // x2 = LN2(x1 + y) into bufA
  layer_norm_rows<T, __nv_bfloat16, kP>(nullptr, nullptr, bufB, bufA, ln2s,
                                        ln2b, eps, bufA, nullptr, q0, L, 0);
  // out = x2 @ Wp + bp, or with a residual res + (x2 @ Wp + bp) in fp32,
  // rounded once (the whole-SRB kernel's epilogue, fused_srb.py:119)
  tile_matmul_mma<kC, kC>(bufA, ws, nullptr, [&](int r, int c, float v0,
                                                 float v1) {
    if (q0 + r >= L) return;
    const size_t i = (img + q0 + r) * kC + c;
    v0 += bp[c];
    v1 += bp[c + 1];
    if (res != nullptr) {
      v0 = to_f(res[i]) + v0;
      v1 = to_f(res[i + 1]) + v1;
    }
    store2(out + i, v0, v1);
  });
}

// ---- fp32: split TF32 on the tensor cores (design at the top) ------------
// 16 warps a block: warp w owns the 16 q rows (w%4)*16..+15 and the 32
// output columns (w/4)*32..+31 (one head of 32, or half of one of 64).
// Every fp32 tile in shared memory has a row pitch of 4 floats past its
// width (8 for the staged weights), which keeps the fragment loads of the
// m16n8k8 products free of bank conflicts. A K/V tile (64 keys of every
// head) lands raw in the landing stage [K | V] by cp.async, and is split
// from there into TF32 hi and lo once, into the working stage
// [K | K lo | V | V lo], each head's columns by that head's warps; the
// next tile lands while this one is computed. After the loop the working
// stage holds the two working tiles, and the landing stage (2 KB longer)
// one whole weight.
constexpr int kF32Warps = 16;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kTK = 64;                     // keys per K/V tile
constexpr int kPF = kD + 4;                 // pitch of the (rows, 128) tiles
constexpr int kTileF = kTK * kPF;           // a (64, 128) K or V tile
constexpr int kStageF = 4 * kTileF;         // [K | K lo | V | V lo]
constexpr int kWF = kD * (kD + 8);          // a staged (128, 128) weight
constexpr int kF32SmemBytes =
    (kStageF + kWF) * (int)sizeof(float);   // 204,800
static_assert(2 * kT * kPF <= kStageF, "bufA and bufB fit the working stage");
static_assert(2 * kTileF <= kWF, "a raw K/V tile fits the landing stage");

// The DH columns of one head of `rows` rows of one part of the fp32 qkv
// (row stride kQKV) into the (kTK, DH) columns of a tile at dst (pitch
// kPF) with 16-byte cp.async copies, by the 4 * DH threads of the head's
// group (gt: the thread's index in it); rows from `rows` to kTK - 1 (past
// L) are stored as zeros
template <int DH>
__device__ __forceinline__ void stage_head_f32(float* dst,
                                               const float* __restrict__ src,
                                               int rows, int gt) {
  constexpr int C = DH / 4;   // 16-byte chunks a row
  for (int e = gt; e < kTK * C; e += 4 * DH) {
    const int r = e / C, c = e % C;
    float* d = dst + r * kPF + c * 4;
    if (r < rows)
      cp_async16(d, src + (size_t)r * kQKV + c * 4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the row-major (128, N) fp32 weight W into ws (pitch N + 8), as 16-byte
// cp.async copies in flight until cp_async_wait
template <int N>
__device__ __forceinline__ void stage_weight_f32(float* ws,
                                                 const float* __restrict__ W) {
  constexpr int C = N / 4;
  for (int e = threadIdx.x; e < kD * C; e += kF32Threads) {
    const int r = e / C, c = e % C;
    cp_async16(ws + r * (N + 8) + c * 4, W + (size_t)r * N + c * 4);
  }
}

// The (kTK, DH) columns of one head of the tile x split into TF32 hi and
// lo, each at the same offsets, by the head's group (as stage_head_f32)
template <int DH>
__device__ __forceinline__ void split_head_f32(const float* x, float* hi,
                                               float* lo, int gt) {
  constexpr int C = DH / 4;
  for (int e = gt; e < kTK * C; e += 4 * DH) {
    const int off = (e / C) * kPF + (e % C) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// a barrier for the `threads` threads (whole warps) that name barrier `id`
// (1-15; 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Attention of this block's 64 q rows over the image's L keys, every head,
// in split TF32: this warp's q rows of its head are split once into
// registers (rows past L as zeros); per 64-key tile S = Q K^T (the small
// products of every k-step first), the scores scaled in fp32, an online
// softmax with a true per-row max on the accumulator fragments (expf),
// this tile's P V from zero with P as the A operand (mma3_xb), added to
// the running sum rescaled by alpha; o = acc * (1 / l) into bufA. The
// warps of one head (4 at DH 32, 8 at DH 64) form a group that copies,
// splits and reads only that head's columns of the K/V tiles, and waits
// only for itself, on a named barrier of its own, so the groups run out
// of step: one group's copies, split and barriers overlap the others'
// products. Two group barriers a tile: after the first, the tile has
// landed and the group is done with the tile before; after the second,
// it is split and the group's columns of the landing stage are free, so
// the next tile's copies are issued and land while this one is computed.
// Once every warp is done, Wout's copies, the epilogue's first weight,
// are issued into the landing stage. A ragged last tile has zero rows and
// its scores past L masked to -inf.
template <int DH>
__device__ __forceinline__ void attention_tf32x3(
    const float* __restrict__ qkv, size_t img, int q0, int L, float* smem,
    const float* __restrict__ wout, float* ws, float* bufA) {
  constexpr int KS = DH / 8;     // k-steps of Q K^T
  constexpr int NS = kTK / 8;    // key n-tiles of a tile
  constexpr int NO = 32 / 8;     // n-tiles of this warp's output columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma group and lane in it
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  const int hc = c0 / DH * DH;             // first column of its head
  // the head's group: its named barrier and this thread's index in it
  const int grp = warp / (DH / 8), gt = threadIdx.x - grp * 4 * DH;
  const float scale = 1.f / sqrtf((float)DH);
  const int tiles = (L + kTK - 1) / kTK;
  const float* rows0 = qkv + img * kQKV;   // row 0 of this image
  float* st = smem;                  // the working stage
  float* land = smem + kStageF;      // the landing stage
  auto load_kv = [&](int j) {
    const int k0 = j * kTK, n = min(kTK, L - k0);
    const float* src = rows0 + (size_t)k0 * kQKV + hc;
    stage_head_f32<DH>(land + hc, src + kD, n, gt);
    stage_head_f32<DH>(land + kTileF + hc, src + 2 * kD, n, gt);
  };
  load_kv(0);
  cp_async_commit();

  AOperand<KS> qa;
  {
    const int ra = q0 + r0 + g, rb = ra + 8;
    const float* pa = rows0 + (size_t)ra * kQKV + hc + t;
    const float* pb = pa + 8 * kQKV;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      split_tf32(ra < L ? pa[kk * 8] : 0.f, qa.h[kk][0], qa.l[kk][0]);
      split_tf32(rb < L ? pb[kk * 8] : 0.f, qa.h[kk][1], qa.l[kk][1]);
      split_tf32(ra < L ? pa[kk * 8 + 4] : 0.f, qa.h[kk][2], qa.l[kk][2]);
      split_tf32(rb < L ? pb[kk * 8 + 4] : 0.f, qa.h[kk][3], qa.l[kk][3]);
    }
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this lane's rows g (c = 0, 1) and g + 8 (c = 2, 3)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();   // tile j has landed, from this thread's copies
    bar_sync(1 + grp, 4 * DH);
    split_head_f32<DH>(land + hc, st + hc, st + kTileF + hc, gt);
    split_head_f32<DH>(land + kTileF + hc, st + 2 * kTileF + hc,
                       st + 3 * kTileF + hc, gt);
    bar_sync(1 + grp, 4 * DH);
    if (j + 1 < tiles) {
      load_kv(j + 1);
      cp_async_commit();
    }
    const int k0 = j * kTK;
    const bool ragged = k0 + kTK > L;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float c[1][4];
      mma3_abt<KS, 1, kPF>(c, qa, st + n * 8 * kPF + hc,
                           st + kTileF + n * 8 * kPF + hc, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = c[0][i];
    }
    // the scaled fp32 scores (key columns n*8 + 2t + (c & 1)) and the
    // running max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = __fmul_rn(s[n][c], scale);
        if (ragged && k0 + n * 8 + 2 * t + (c & 1) >= L) x = -INFINITY;
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // key k0 is valid in every tile, so this is finite
      const float m_new = fmaxf(m[rr], quad_max(mx[rr]));
      alpha[rr] = expf(m[rr] - m_new);   // 0 on the first tile
      m[rr] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = expf(s[n][c] - m[c >> 1]);
        sum[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      l[rr] = l[rr] * alpha[rr] + quad_sum(sum[rr]);
    // this tile's P V from 0, then added to the rescaled running sum
    float part[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      mma3_xb<NO, kPF>(part, s[kk], st + 2 * kTileF + kk * 8 * kPF + c0,
                       st + 3 * kTileF + kk * 8 * kPF + c0, g, t);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n][c] = fmaf(acc[n][c], alpha[c >> 1], part[n][c]);
  }
  __syncthreads();   // every warp is done with both stages
  stage_weight_f32<kD>(ws, wout);
  cp_async_commit();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(bufA + (r0 + g + 8 * hr) * kPF + c0 +
                                 n * 8 + 2 * t) =
          make_float2(acc[n][2 * hr] * inv, acc[n][2 * hr + 1] * inv);
  }
}

// out = in @ W in split TF32 for the (64, 128) fp32 tile `in` (pitch kPF)
// and a row-major (128, N) weight whose cp.async copies into ws (pitch
// N + 8) are committed. Warp w owns rows (w%4)*16..+15 and the column
// quarter w/4; each k-step's A fragment is split as it is loaded. Waits
// for the copies, runs the products, and once every warp is done reading
// `in` and ws, commits the copies of the next weight `next` ((128, NN);
// none when null) into ws, so that they land during the stores and the
// LayerNorm after them; then calls store(row, col, v0, v1) for columns
// col, col + 1, which may overwrite `in`.
template <int N, int NN, typename Store>
__device__ __forceinline__ void tile_matmul_tf32x3(
    const float* in, float* ws, const float* __restrict__ next, Store store) {
  constexpr int NT = N / 32;   // n-tiles of 8 per warp (a quarter)
  constexpr int SW = N + 8;    // row pitch of the staged W
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * (N / 4);
  cp_async_wait<0>();
  __syncthreads();   // W is in from every thread's copies; `in` is written
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < kD / 8; ++ks) {
    const float* a = in + (r0 + g) * kPF + ks * 8 + t;
    uint32_t ah[4], al[4];
    split_tf32(a[0], ah[0], al[0]);
    split_tf32(a[8 * kPF], ah[1], al[1]);
    split_tf32(a[4], ah[2], al[2]);
    split_tf32(a[8 * kPF + 4], ah[3], al[3]);
    mma3_kstep<NT, SW>(acc, ah, al, ws + (ks * 8 + t) * SW + c0 + g);
  }
  __syncthreads();   // every warp is done reading `in` and ws
  if (next != nullptr) {
    stage_weight_f32<NN>(ws, next);
    cp_async_commit();
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      store(r0 + g + 8 * hr, c0 + n * 8 + 2 * t, acc[n][2 * hr],
            acc[n][2 * hr + 1]);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads, 1)
attn_epilogue_tf32x3_kernel(
    const float* __restrict__ qkv, const float* __restrict__ tokens,
    const float* __restrict__ pe, const float* __restrict__ wout,
    const float* __restrict__ bout, const float* __restrict__ ln1s,
    const float* __restrict__ ln1b, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ ln2s,
    const float* __restrict__ ln2b, const float* __restrict__ wp,
    const float* __restrict__ bp, const float* __restrict__ res,
    float* __restrict__ out, int L, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * kT;
  const size_t img = (size_t)blockIdx.y * L;   // first row of this image
  // the working tiles take the working stage, the weights the landing one
  float* bufA = smem;
  float* bufB = bufA + kT * kPF;   // x1, kept for the second residual
  float* ws = smem + kStageF;
  attention_tf32x3<DH>(qkv, img, q0, L, smem, wout, ws, bufA);
  // out = attn @ Wout + bout, in place in bufA
  tile_matmul_tf32x3<kD, kD>(bufA, ws, w1, [&](int r, int c, float v0,
                                               float v1) {
    store2(bufA + r * kPF + c, v0 + bout[c], v1 + bout[c + 1]);
  });
  __syncthreads();
  // x1 = LN1(x + out) into bufA and bufB
  layer_norm_rows<float, float, kPF, kF32Warps>(tokens, pe, nullptr, bufA,
                                                ln1s, ln1b, eps, bufA, bufB,
                                                q0, L, (img + q0) * kC);
  // relu(x1 @ W1 + b1)
  tile_matmul_tf32x3<kD, kD>(bufA, ws, w2, [&](int r, int c, float v0,
                                               float v1) {
    store2(bufA + r * kPF + c, fmaxf(v0 + b1[c], 0.f),
           fmaxf(v1 + b1[c + 1], 0.f));
  });
  // y = h @ W2 + b2
  tile_matmul_tf32x3<kD, kC>(bufA, ws, wp, [&](int r, int c, float v0,
                                               float v1) {
    store2(bufA + r * kPF + c, v0 + b2[c], v1 + b2[c + 1]);
  });
  __syncthreads();
  // x2 = LN2(x1 + y) into bufA
  layer_norm_rows<float, float, kPF, kF32Warps>(nullptr, nullptr, bufB,
                                                bufA, ln2s, ln2b, eps, bufA,
                                                nullptr, q0, L, 0);
  // out = x2 @ Wp + bp, or with a residual res + (x2 @ Wp + bp)
  tile_matmul_tf32x3<kC, kC>(bufA, ws, nullptr, [&](int r, int c, float v0,
                                                    float v1) {
    if (q0 + r >= L) return;
    const size_t i = (img + q0 + r) * kC + c;
    v0 += bp[c];
    v1 += bp[c + 1];
    if (res != nullptr) {
      v0 = res[i] + v0;
      v1 = res[i + 1] + v1;
    }
    store2(out + i, v0, v1);
  });
}

template <typename T>
int launch_qkv(const void* tokens, const void* wtop, const void* peqkv,
               void* qkv, int rows, int L, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_proj_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kQkvSmemBytes);
    if (err != cudaSuccess) return (int)err;
    qkv_proj_mma_kernel<<<(rows + kQRows - 1) / kQRows, kThreads,
                          kQkvSmemBytes, stream>>>(
        (const T*)tokens, (const T*)wtop, (const float*)peqkv, (T*)qkv, rows,
        L);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_proj_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kQkvF32SmemBytes);
    if (err != cudaSuccess) return (int)err;
    qkv_proj_tf32x3_kernel<<<(rows + kQRows - 1) / kQRows, kThreads,
                             kQkvF32SmemBytes, stream>>>(
        (const float*)tokens, (const float*)wtop, (const float*)peqkv,
        (float*)qkv, rows, L);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_attn(const void* const* p, void* out, int B, int L, float eps,
                cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int bytes = f32 ? kF32SmemBytes : kMmaSmemBytes;
  dim3 grid((L + kT - 1) / kT, B);
  if constexpr (f32) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_epilogue_tf32x3_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attn_epilogue_tf32x3_kernel<DH><<<grid, kF32Threads, bytes, stream>>>(
        (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
        (const float*)p[4], (const float*)p[5], (const float*)p[6],
        (const T*)p[7], (const float*)p[8], (const T*)p[9],
        (const float*)p[10], (const float*)p[11], (const float*)p[12],
        (const T*)p[13], (const float*)p[14], (const T*)p[15], (T*)out, L,
        eps);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        attn_epilogue_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attn_epilogue_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
        (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
        (const float*)p[4], (const float*)p[5], (const float*)p[6],
        (const T*)p[7], (const float*)p[8], (const T*)p[9],
        (const float*)p[10], (const float*)p[11], (const float*)p[12],
        (const T*)p[13], (const float*)p[14], (const T*)p[15], (T*)out, L,
        eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* fe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// C interface. Every pointer is a device pointer; T is bf16 when `bf16` is
// nonzero, else fp32; biases, LN parameters and peqkv are always fp32.
// Each entry returns cudaGetLastError() after its launch (0 = success).
extern "C" int fe_qkv_proj(const void* tokens, const void* wtop,
                           const void* peqkv, void* qkv, int rows, int L,
                           int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_qkv<__nv_bfloat16>(tokens, wtop, peqkv, qkv, rows, L, s)
              : launch_qkv<float>(tokens, wtop, peqkv, qkv, rows, L, s);
}

// `res` is null for the enhancer alone (B1); the whole-SRB kernel (B9,
// csrc/fused_srb.cu) passes its block input, (B, L, 64) at T, and gets
// T(res + x2 @ Wp + bp). Returns cudaErrorInvalidValue for a head width
// other than 32 or 64.
extern "C" int fe_attn_epilogue(
    const void* qkv, const void* tokens, const void* pe, const void* wout,
    const void* bout, const void* ln1s, const void* ln1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2s,
    const void* ln2b, const void* wp, const void* bp, const void* res,
    void* out, int B, int L, int dh, float eps, int bf16, void* stream) {
  const void* p[16] = {qkv, tokens, pe,  wout, bout, ln1s, ln1b, w1,
                       b1,  w2,     b2,  ln2s, ln2b, wp,   bp,   res};
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 32)
    return bf16 ? launch_attn<__nv_bfloat16, 32>(p, out, B, L, eps, s)
                : launch_attn<float, 32>(p, out, B, L, eps, s);
  if (dh == 64)
    return bf16 ? launch_attn<__nv_bfloat16, 64>(p, out, B, L, eps, s)
                : launch_attn<float, 64>(p, out, B, L, eps, s);
  return (int)cudaErrorInvalidValue;
}
