// Softmax attention forward over strided q/k/v/o, unmasked or region-masked,
// hand-written for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces three Pallas TPU kernels of the JAX package (fudanocr_tpu/ops/):
//   * region_attention.py `_plain_fwd` (:280, pallas_call :284), reached
//     through `packed_flash_mha` (:340): lane-packed q (B, Lq, H*dh) and
//     k/v (B, Lkv, H*dh), head h in columns [h*dh, (h+1)*dh);
//   * region_attention.py `_region_fwd` (:167, pallas_call :177), reached
//     through `region_flash_mha` (:239): the same packed layout plus
//     (B, Lq) and (B, Lkv) fp32 region ids;
//   * flash_attention.py `_mha_full` (:119, pallas_call :122) and the
//     online-softmax `_flash_mha_impl` (:653, pallas_call :682), reached
//     through `flash_mha` (:620): (B, H, L, dh) operands.
// They compute one function and differ only in layout and the mask, so one
// kernel takes batch, head and row strides (in elements; the feature stride
// is 1) for each operand and a compile-time MASKED flag. The Python
// wrappers, with their launch counters and the plain PyTorch versions, are
// `packed_flash_mha` and `region_flash_mha` in
// fudanocr_tpu_torch/ops/region_attention.py and `flash_mha` in
// fudanocr_tpu_torch/ops/flash_attention.py.
//
// Per (image b, head h), with scale = 1/sqrt(dh):
//   s = q k^T * scale (fp32),  o = softmax_rows(s) v,
// row max subtracted, fp32 statistics and accumulation, o in the input type
// (fp32 or bf16; bf16 inputs are widened on load). MASKED adds the det-
// guided suppression of the reference (cascade_mit.py calculate_mask):
//   s_ij = (q_i . k_j * scale) + (rq_i == rkv_j ? -1e10 : 0),
// rounded after the product and again after the sum, before the row max,
// as the JAX kernel does. In fp32 the spacing near 1e10 is 1024, so every
// |s| < 512 suppressed score becomes exactly -1e10: a row whose keys are
// all suppressed is uniform (o = mean of v), not the softmax of its scores.
// The kernel never skips a suppressed key and starts its running max at
// -inf, so such a row comes out as the plain version computes it.
//
// Design: one block of 128 threads per (128-row q tile, head, image), one
// thread per q row holding its q row and its output accumulator in
// registers. K and V of one head do not fit in shared memory at the
// segmentation shapes (Lkv = 1024, dh = 32, fp32: 256 KB; 1 MB at
// Lkv = 4096), so they stream through it in tiles of 64 keys (16 KB at
// dh = 32, 32 KB at dh = 64) with an online softmax: per chunk of keys the
// running max, the running denominator and the accumulator are rescaled
// once. Nothing of size Lq x Lkv touches device memory.
//
// What bounds it on this card: 4*B*H*Lq*Lkv*dh flops (two products) against
// each of q, k, v (and the ids) read once and o written once. At the slide
// recipe's stage 0 (B = 3, Lq = 65,536, Lkv = 1024, dh = 32, fp32) that is
// 25.8 GFLOP against 51 MB: fp32 FMA sets the bound (0.38 ms at 67 TFLOP/s
// against 0.015 ms for the bytes). The design spends its registers on
// FMAs: each K/V row is read from shared memory as a broadcast (every
// thread of the warp reads the same 16 bytes) and feeds one FMA per
// feature per thread. The mask costs one compare and one add per score:
// the thread that owns a q row keeps its id in a register, and each 64-key
// tile stages its kv ids into shared memory beside K and V. fp32 stays on
// CUDA cores because TF32 misses the fp32 bar; bf16 on tensor cores
// (mma.sync / wgmma, TMA-fed K/V) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // q rows per block = threads per block
constexpr int kTile = 64;    // keys per K/V tile in shared memory
constexpr float kNeg = -1e10f;   // the reference's suppression constant

struct Strides {   // element strides of one operand
  int64_t b, h, r;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// r . row, row a 16-byte aligned row of DH floats in shared memory (a
// broadcast: every thread reads the same row)
template <int DH>
__device__ __forceinline__ float dot_sm(const float* r, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 4; i += 2) {
    const float4 u = r4[i];
    const float4 w = r4[i + 1];
    a0 = fmaf(r[4 * i], u.x, a0);
    a0 = fmaf(r[4 * i + 1], u.y, a0);
    a0 = fmaf(r[4 * i + 2], u.z, a0);
    a0 = fmaf(r[4 * i + 3], u.w, a0);
    a1 = fmaf(r[4 * i + 4], w.x, a1);
    a1 = fmaf(r[4 * i + 5], w.y, a1);
    a1 = fmaf(r[4 * i + 6], w.z, a1);
    a1 = fmaf(r[4 * i + 7], w.w, a1);
  }
  return a0 + a1;
}

// acc += c * row (row in shared memory, as above)
template <int DH>
__device__ __forceinline__ void axpy_sm(float* acc, float c,
                                        const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) {
    const float4 u = r4[i];
    acc[4 * i] = fmaf(c, u.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(c, u.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(c, u.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(c, u.w, acc[4 * i + 3]);
  }
}

// Copy kTile rows of DH features, rows r0.. of a matrix with row stride
// `stride` at src, into the (kTile, DH) fp32 tile dst. Neighbouring threads
// read neighbouring features of a row.
template <typename T, int DH>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int64_t stride, int r0,
                                           float* dst) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * DH; i += kRows)
    dst[i] = to_f(src[(int64_t)(r0 + i / DH) * stride + i % DH]);
}

template <typename T, int DH, bool MASKED>
__global__ void __launch_bounds__(kRows)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                const float* __restrict__ rq, const float* __restrict__ rkv,
                int Lq, int Lkv, Strides sq, Strides sk, Strides sv,
                Strides so, float scale) {
  // scores held in registers per online-softmax step: fewer at dh = 64,
  // where the q row and the accumulator take 128 registers
  constexpr int kChunk = DH == 32 ? 32 : 16;
  __shared__ __align__(16) float ks[kTile * DH];
  __shared__ __align__(16) float vs[kTile * DH];
  __shared__ float ids[MASKED ? kTile : 1];
  const int b = blockIdx.z, h = blockIdx.y;
  const int64_t row = (int64_t)blockIdx.x * kRows + threadIdx.x;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float rid = MASKED ? rq[(int64_t)b * Lq + row] : 0.f;

  float qr[DH], acc[DH];
  const T* qp = q + b * sq.b + h * sq.h + row * sq.r;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qr[i] = to_f(qp[i]);
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Lkv; k0 += kTile) {
    __syncthreads();
    stage_tile<T, DH>(kb, sk.r, k0, ks);
    stage_tile<T, DH>(vb, sv.r, k0, vs);
    if (MASKED && threadIdx.x < kTile)
      ids[threadIdx.x] = rkv[(int64_t)b * Lkv + k0 + threadIdx.x];
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float d = dot_sm<DH>(qr, ks + (c0 + j) * DH);
        // the masked sum is rounded twice (product, then sum), never
        // contracted into one FMA, to keep the JAX kernel's rounding
        s[j] = MASKED ? __fadd_rn(__fmul_rn(d, scale),
                                  rid == ids[c0 + j] ? kNeg : 0.f)
                      : d * scale;
        cmax = fmaxf(cmax, s[j]);
      }
      const float mnew = fmaxf(m, cmax);
      const float alpha = __expf(m - mnew);   // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = __expf(s[j] - mnew);
        l += p;
        axpy_sm<DH>(acc, p, vs + (c0 + j) * DH);
      }
      m = mnew;
    }
  }
  const float inv = 1.f / l;
  T* op = o + b * so.b + h * so.h + row * so.r;
#pragma unroll
  for (int i = 0; i < DH; ++i) store_f(op + i, acc[i] * inv);
}

template <typename T, int DH, bool MASKED>
void launch_typed(const void* q, const void* k, const void* v, void* o,
                  const float* rq, const float* rkv, dim3 grid, int Lq,
                  int Lkv, Strides sq, Strides sk, Strides sv, Strides so,
                  float scale, cudaStream_t s) {
  attn_fwd_kernel<T, DH, MASKED><<<grid, kRows, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, rq, rkv, Lq, Lkv, sq,
      sk, sv, so, scale);
}

template <bool MASKED>
void launch_masked(const void* q, const void* k, const void* v, void* o,
                   const float* rq, const float* rkv, dim3 grid, int Lq,
                   int Lkv, int dh, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, int bf16, cudaStream_t s) {
  if (bf16 && dh == 32)
    launch_typed<__nv_bfloat16, 32, MASKED>(q, k, v, o, rq, rkv, grid, Lq,
                                            Lkv, sq, sk, sv, so, scale, s);
  else if (bf16)
    launch_typed<__nv_bfloat16, 64, MASKED>(q, k, v, o, rq, rkv, grid, Lq,
                                            Lkv, sq, sk, sv, so, scale, s);
  else if (dh == 32)
    launch_typed<float, 32, MASKED>(q, k, v, o, rq, rkv, grid, Lq, Lkv, sq,
                                    sk, sv, so, scale, s);
  else
    launch_typed<float, 64, MASKED>(q, k, v, o, rq, rkv, grid, Lq, Lkv, sq,
                                    sk, sv, so, scale, s);
}

// rq == rkv == nullptr: unmasked; both set: region-masked
int launch(const void* q, const void* k, const void* v, void* o,
           const float* rq, const float* rkv, int B, int H, int Lq, int Lkv,
           int dh, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, int bf16, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535 || Lq < kRows ||
      Lq % kRows || Lkv < kTile || Lkv % kTile || (dh != 32 && dh != 64) ||
      (rq == nullptr) != (rkv == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Lq / kRows, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (rq)
    launch_masked<true>(q, k, v, o, rq, rkv, grid, Lq, Lkv, dh, sq, sk, sv,
                        so, scale, bf16, s);
  else
    launch_masked<false>(q, k, v, o, rq, rkv, grid, Lq, Lkv, dh, sq, sk, sv,
                         so, scale, bf16, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = success);
// bf16 selects the element type of q/k/v/o (fp32 otherwise). Strides are in
// elements; the feature stride is 1. Lq must be a multiple of 128, Lkv of
// 64, dh 32 or 64.

// Packed layout (B7): q (B, Lq, H*dh) with row stride q_row, k/v
// (B, Lkv, H*dh) with row strides k_row/v_row, o (B, Lq, H*dh) with row
// stride o_row; an image's rows follow each other (batch stride L * row).
extern "C" int attn_unmasked_packed_fwd(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int Lq, int Lkv, int dh,
                                        int64_t q_row, int64_t k_row,
                                        int64_t v_row, int64_t o_row,
                                        float scale, int bf16, void* stream) {
  const int64_t hs = dh;   // head h starts at column h * dh
  return launch(q, k, v, o, nullptr, nullptr, B, H, Lq, Lkv, dh,
                {Lq * q_row, hs, q_row}, {Lkv * k_row, hs, k_row},
                {Lkv * v_row, hs, v_row}, {Lq * o_row, hs, o_row}, scale,
                bf16, stream);
}

// Region-masked packed layout (B6): as attn_unmasked_packed_fwd, plus fp32
// region ids rq (B, Lq) and rkv (B, Lkv), contiguous (batch stride L);
// pairs with equal ids get -1e10 added to their score.
extern "C" int attn_region_packed_fwd(const void* q, const void* k,
                                      const void* v, const float* rq,
                                      const float* rkv, void* o, int B, int H,
                                      int Lq, int Lkv, int dh, int64_t q_row,
                                      int64_t k_row, int64_t v_row,
                                      int64_t o_row, float scale, int bf16,
                                      void* stream) {
  if (rq == nullptr || rkv == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t hs = dh;
  return launch(q, k, v, o, rq, rkv, B, H, Lq, Lkv, dh,
                {Lq * q_row, hs, q_row}, {Lkv * k_row, hs, k_row},
                {Lkv * v_row, hs, v_row}, {Lq * o_row, hs, o_row}, scale,
                bf16, stream);
}

// Head-major layout (B5): q/o (B, H, Lq, dh) and k/v (B, H, Lkv, dh), each
// with its own (batch, head, row) strides, so a (B, H, L, dh) view of a
// (B, L, H, dh) buffer is read in place.
extern "C" int attn_unmasked_bhld_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Lq, int Lkv, int dh, int64_t q_b, int64_t q_h, int64_t q_r,
    int64_t k_b, int64_t k_h, int64_t k_r, int64_t v_b, int64_t v_h,
    int64_t v_r, int64_t o_b, int64_t o_h, int64_t o_r, float scale,
    int bf16, void* stream) {
  return launch(q, k, v, o, nullptr, nullptr, B, H, Lq, Lkv, dh,
                {q_b, q_h, q_r}, {k_b, k_h, k_r}, {v_b, v_h, v_r},
                {o_b, o_h, o_r}, scale, bf16, stream);
}
