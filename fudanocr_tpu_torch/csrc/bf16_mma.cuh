// bf16 tensor-core helpers shared by the hand-written Hopper kernels
// (csrc/fused_enhancer.cu, csrc/fused_srb.cu, csrc/unmasked_attention.cu,
// csrc/flash_attention_dropout.cu): mma.sync m16n8k16 with fp32
// accumulators, the fragment loads that feed it from shared memory, the
// packing of fp32 pairs into bf16 fragments, the cp.async copies that
// stage bf16 row tiles into shared memory, and the attention kernels'
// products on those tiles (S = Q K^T, O += P V and their transposes).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// d += a b on the tensor cores: bf16 A (16x16, row), B (16x8, col), fp32 D
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent bf16 values as one 32-bit register (an A or B fragment half)
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two fp32 values rounded to bf16 in one 32-bit register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragments of two adjacent n-tiles from a row-major (k, n) bf16 tile in
// shared memory: lane L points at row k0 + (L & 15), columns n0 + (L >> 4)*8;
// r[0], r[1] are b0, b1 of columns n0..n0+7 and r[2], r[3] of n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// 4 bytes, 4-byte aligned at both ends
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of DH bf16 features, row r at src + r * stride, into the
// shared tile dst with row pitch DH + 8, with the THREADS threads of the
// block. VEC16: 16-byte cp.async copies (in flight until cp_async_wait);
// otherwise 2-byte loads and stores.
template <int DH, bool VEC16, int THREADS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int rows) {
  constexpr int P = DH + 8;
  if (VEC16) {
    constexpr int C = DH / 8;   // 16-byte chunks per row
    for (int e = threadIdx.x; e < rows * C; e += THREADS) {
      const int r = e / C, c = e % C;
      cp_async16(dst + r * P + c * 8, src + r * stride + c * 8);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DH; e += THREADS) {
      const int r = e / DH, c = e % DH;
      dst[r * P + c] = src[r * stride + c];
    }
  }
}

// two adjacent bf16 values of global memory as one fragment register
// (VEC16: one 4-byte load; otherwise two 2-byte loads)
template <bool VEC16>
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  if (VEC16) return *reinterpret_cast<const uint32_t*>(p);
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[1];
  return *reinterpret_cast<uint32_t*>(&v);
}

// lo, hi rounded to bf16 at p, p + 1
template <bool VEC16>
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float lo, float hi) {
  if (VEC16) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
  } else {
    p[0] = __float2bfloat16(lo);
    p[1] = __float2bfloat16(hi);
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// the sum of v over the 4 lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The m16n8k16 A fragments of 16 rows x 16*KS features of a row-major bf16
// matrix in global memory (row 0 at src): lane (g, t) holds rows g, g + 8
// and the feature pairs kk*16 + 2t, kk*16 + 2t + 8
template <bool VEC16, int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4],
                                       const __nv_bfloat16* src,
                                       int64_t stride, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* p = src + g * stride + kk * 16 + 2 * t;
    a[kk][0] = ld_pair<VEC16>(p);
    a[kk][1] = ld_pair<VEC16>(p + 8 * stride);
    a[kk][2] = ld_pair<VEC16>(p + 8);
    a[kk][3] = ld_pair<VEC16>(p + 8 * stride + 8);
  }
}

// c (16 x 8*NS, fp32) = a (16 x 16*KS) b^T, b an (8*NS, 16*KS) shared tile
// with row pitch 16*KS + 8: S = Q K^T and dP = dO V^T, or their transposes
// K Q^T and V dO^T
template <int NS, int KS>
__device__ __forceinline__ void mma_abt(float (&c)[NS][4],
                                        const uint32_t (&a)[KS][4],
                                        const __nv_bfloat16* b, int g, int t) {
  constexpr int P = 16 * KS + 8;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const __nv_bfloat16* p = b + (n * 8 + g) * P + kk * 16 + 2 * t;
      mma_bf16(c[n], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

// acc (16 x 8*NO) += bf16(x) b, x (16 x 8*NS) in accumulator fragments:
// the fragments of key (or q) n-tiles 2kk, 2kk + 1 are the A fragment of
// k-step kk, repacked in registers; b an (8*NS, 8*NO) shared tile with row
// pitch 8*NO + 8, read through ldmatrix.trans. O += P V, dQ += dS K,
// dV += P^T dO, dK += dS^T Q. SPLIT: x as a bf16 pair hi + lo (lo = x - hi,
// rounded), two products, x to ~16 significant bits
template <bool SPLIT = false, int NO, int NS>
__device__ __forceinline__ void mma_xb(float (&acc)[NO][4],
                                       const float (&x)[NS][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int P = 8 * NO + 8;
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* xi = x[2 * kk + (i >> 1)] + 2 * (i & 1);
      pa[i] = pack_bf16(xi[0], xi[1]);
      if (SPLIT) {
        const float2 h = unpack_bf16(pa[i]);
        pl[i] = pack_bf16(xi[0] - h.x, xi[1] - h.y);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 + (lane & 15)) * P + n * 8 +
                                (lane >> 4) * 8);
      mma_bf16(acc[n], pa, bf[0], bf[1]);
      mma_bf16(acc[n + 1], pa, bf[2], bf[3]);
      if (SPLIT) {
        mma_bf16(acc[n], pl, bf[0], bf[1]);
        mma_bf16(acc[n + 1], pl, bf[2], bf[3]);
      }
    }
  }
}

}  // namespace
