// Split-TF32 (3xTF32) helpers of the fp32 attention kernels (the
// segmentation attention, csrc/unmasked_attention_fwd_tf32x3.cu and
// _bwd_tf32x3.cu, why and how: the top of csrc/unmasked_attention.cu; the
// dropout attention, csrc/flash_attention_dropout_tf32x3.cu): the split of
// an fp32 value into TF32 hi + lo, mma.sync m16n8k8 on TF32, the A operand
// held in registers, the two 3xTF32 products with their fragment loads,
// the running sums kept in shared memory, and the staging of fp32 tiles
// into shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"   // cp.async, quad_sum
#include "unmasked_attention.cuh"

namespace {

using namespace seg_attn;

// x rounded to TF32 (cvt.rna: to nearest, ties away from zero), as the
// bits of an fp32 whose 13 low mantissa bits are zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32, |x - hi - lo| < 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: TF32 A (16x8, row), B (8x8, col), fp32 D
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ldb(const float* p) {
  return __float_as_uint(*p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The A operand of a warp's 16 rows x KS*8 features (m16n8k8: lane (g, t)
// holds rows g, g + 8 and features kk*8 + t, kk*8 + t + 4 as a0..a3),
// split once into TF32 hi (h) and lo (l)
template <int KS>
struct AOperand {
  uint32_t h[KS][4], l[KS][4];
};

// a <- rows g, g + 8 of the row-major fp32 rows at src (row stride
// `stride`), features kk*8 + t and kk*8 + t + 4
template <int KS>
__device__ __forceinline__ void load_a(AOperand<KS>& a,
                                       const float* __restrict__ src,
                                       int64_t stride, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float* p = src + g * stride + kk * 8 + t;
    split_tf32(p[0], a.h[kk][0], a.l[kk][0]);
    split_tf32(p[8 * stride], a.h[kk][1], a.l[kk][1]);
    split_tf32(p[4], a.h[kk][2], a.l[kk][2]);
    split_tf32(p[8 * stride + 4], a.h[kk][3], a.l[kk][3]);
  }
}

// c[n] = A B_n^T in 3xTF32 for the NT n-tiles n of 8 rows of a tile split
// into hi (bh) and lo (bl), row-major (row, feature) with pitch P, so the B
// fragment is b0 = (row g, feature kk*8 + t), b1 = feature + 4. Each
// c[n] starts from 0 and takes the small products of every k-step first,
// then the large ones: S = Q K^T, dP = dO V^T and their transposes K Q^T,
// V dO^T.
template <int KS, int NT, int P>
__device__ __forceinline__ void mma3_abt(float (&c)[NT][4],
                                         const AOperand<KS>& a,
                                         const float* bh, const float* bl,
                                         int g, int t) {
  uint32_t hb[NT][KS][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int off = (n * 8 + g) * P + kk * 8 + t;
      hb[n][kk][0] = ldb(bh + off);
      hb[n][kk][1] = ldb(bh + off + 4);
      mma_tf32(c[n], a.l[kk], hb[n][kk][0], hb[n][kk][1]);
      mma_tf32(c[n], a.h[kk], ldb(bl + off), ldb(bl + off + 4));
    }
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_tf32(c[n], a.h[kk], hb[n][kk][0], hb[n][kk][1]);
}

// acc (16 x NO*8) += X B in 3xTF32: X the accumulator fragment x of one
// n-tile (16 rows x 8 keys, or 16 keys x 8 q rows) taken as the A fragment
// of one k-step by relabelling its 8 columns (k = t is column 2t, k = t + 4
// column 2t + 1: a0 = c0, a1 = c2, a2 = c1, a3 = c3); B the 8 tile rows at
// bh/bl (hi/lo, pitch P), so its fragment comes from rows 2t and 2t + 1.
// The sum runs over the 8 columns, whose order is free. O += P V,
// dQ += dS K, dV += P^T dO, dK += dS^T Q.
template <int NO, int P>
__device__ __forceinline__ void mma3_xb(float (&acc)[NO][4],
                                        const float (&x)[4], const float* bh,
                                        const float* bl, int g, int t) {
  uint32_t xh[4], xl[4];
  split_tf32(x[0], xh[0], xl[0]);
  split_tf32(x[2], xh[1], xl[1]);
  split_tf32(x[1], xh[2], xl[2]);
  split_tf32(x[3], xh[3], xl[3]);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int off = 2 * t * P + n * 8 + g;
    const uint32_t h0 = ldb(bh + off), h1 = ldb(bh + off + P);
    mma_tf32(acc[n], xl, h0, h1);
    mma_tf32(acc[n], xh, ldb(bl + off), ldb(bl + off + P));
    mma_tf32(acc[n], xh, h0, h1);
  }
}

// This lane's elements of a warp's 16 x DH running sum kept in shared
// memory (rows g, g + 8, features n*8 + 2t, + 1; pitch DH + 4), each owned
// by this lane alone: += the fragments x
template <int NO, int P>
__device__ __forceinline__ void add_to(float* mine, const float (&x)[NO][4]) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    mine[n * 8] += x[n][0];
    mine[n * 8 + 1] += x[n][1];
    mine[8 * P + n * 8] += x[n][2];
    mine[8 * P + n * 8 + 1] += x[n][3];
  }
}

// Copy kTile rows of DH floats, row r at src + r * stride, into the shared
// tile dst (row pitch DH + 4) with the block's threads, as cp.async copies
// in flight until cp_async_wait: 16 bytes each where vec16 (a 16-byte
// aligned base and strides of 4 floats), else 4
template <int DH>
__device__ __forceinline__ void copy_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int64_t stride, bool vec16) {
  constexpr int P = DH + 4;
  if (vec16) {
    constexpr int C = DH / 4;
    for (int e = threadIdx.x; e < kTile * C; e += blockDim.x) {
      const int r = e / C, c = e % C;
      cp_async16(dst + r * P + c * 4, src + r * stride + c * 4);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * DH; e += blockDim.x) {
      const int r = e / DH, c = e % DH;
      cp_async4(dst + r * P + c, src + r * stride + c);
    }
  }
}

// Split the kTile x DH tile at x (pitch DH + 4) into TF32 hi, in place,
// and lo, at the same offsets from lo
template <int DH>
__device__ __forceinline__ void split_tile(float* x, float* lo) {
  constexpr int P = DH + 4, C = DH / 4;
  for (int e = threadIdx.x; e < kTile * C; e += blockDim.x) {
    const int off = (e / C) * P + (e % C) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(x + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// floats of one stage of the forward and the dQ pass: [K | K lo | V | V lo]
// tiles and the tile's key ids
template <int DH>
__host__ __device__ constexpr int kv_stage_floats() {
  return 4 * kTile * (DH + 4) + kTile;
}
// floats of one stage of the dK/dV pass: [Q | Q lo | dO | dO lo] tiles and
// the tile's q rows' m, 1/l, D and ids
template <int DH>
__host__ __device__ constexpr int q_stage_floats() {
  return 4 * kTile * (DH + 4) + 4 * kTile;
}

// Blocks an SM of the fp32 kernels at dh = 32 (128 registers a thread);
// at dh = 64 one block, with the registers it needs
constexpr int kTf32Blocks32 = 2;

// fp32 16-byte copies need a 16-byte aligned base and strides of 4 floats
bool aligned16_f32(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.r % 4 == 0;
}

// The dynamic shared memory of a kernel, allowed above 48 KB
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
