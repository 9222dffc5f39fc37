// bf16 tensor-core helpers shared by the hand-written Hopper kernels
// (csrc/fused_enhancer.cu, csrc/fused_srb.cu, csrc/unmasked_attention.cu,
// csrc/flash_attention_dropout.cu): mma.sync m16n8k16 with fp32
// accumulators, the fragment loads that feed it from shared memory, the
// packing of fp32 pairs into bf16 fragments, and the cp.async copies that
// stage bf16 row tiles into shared memory.

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

}  // namespace
