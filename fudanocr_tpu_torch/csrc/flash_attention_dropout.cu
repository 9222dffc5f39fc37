// Self-attention with hash dropout on the probabilities over packed
// (B, L, H*dh) q, k and v: forward and backward, hand-written for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes). Each of
// q, k, v (and dq, dk, dv) has its own base pointer and row stride, so one
// pair of kernels serves two layouts:
//   * the fused (B, L, 3D) [q | k | v] projection (B4): q, k, v at columns
//     0, D, 2D of one buffer with row stride 3D, the gradient into the
//     column slices of one dqkv;
//   * separate q, k, v buffers (B11).
//
// Replaces the Pallas TPU kernels of fudanocr_tpu/ops/flash_attention.py
// `flash_mha_qkv_packed_dropout`: `_qkv_dropout_fwd` (:505, pallas_call
// :511, body `_qkv_dropout_fwd_kernel`) and `_qkv_dropout_bwd` (:528,
// pallas_call :534, body `_qkv_dropout_bwd_kernel`); and of
// `flash_mha_packed_dropout`: `_packed_dropout_fwd` (:373, pallas_call
// :378) and `_packed_dropout_bwd` (:401, pallas_call :407). The Python
// wrappers, the autograd Functions and the plain PyTorch versions live in
// fudanocr_tpu_torch/ops/flash_attention.py.
//
// Per image b and head h (dh = 32, scale = 1/sqrt(dh)):
//   s    = q k^T * scale                          (fp32)
//   p    = exp(s - rowmax(s)),  denom = rowsum(p)  over ALL keys
//   keep = fmix32((q_idx * L + k_idx) ^ bh_seed) < thresh
//   o    = rowsum_k(keep * p * v) * (inv_keep / denom)
// i.e. dropout after the softmax normalisation, the kept probabilities
// divided by the undropped denominator and scaled by 1/(1 - rate). The keep
// decision is the JAX package's counter hash (murmur3 fmix32 of the flat
// (q, k) counter xor a per-(image, head) seed), bit for bit, so the
// backward regenerates it and nothing of size L x L is ever stored.
//
// Forward: one block per (128-row q tile, head, image), one thread per q
// row; K/V tiles of 64 keys stream through shared memory with an online
// softmax that accumulates the denominator over every key and the
// numerator over the kept keys only. It writes o and the per-row
// log-sum-exp lse = max + log(denom) (B*H*L fp32, the only residual beside
// qkv, o and the seed).
//
// Backward, one launch, FlashAttention-2's split with no atomics: with
// D_i = dO_i . o_i (which equals rowsum(dP' * P) under dropout), blocks
// [0, L/128) each own 128 q rows and loop over K/V tiles to build dQ; blocks
// [L/128, L/64) each own 128 keys and loop over Q/dO tiles to build dK and
// dV. Every dqkv element is written once, by one thread: deterministic.
//
// What bounds it on this card: per (image, head) the forward does
// 4*L^2*dh flops (2 products) and the backward 14*L^2*dh (its two roles
// each recompute s and dP), against O(L*dh) bytes: compute-bound. What the
// design does about it: nothing of size L x L touches memory; K/V (or Q/dO)
// rows are read from shared memory as broadcasts and each feeds 32-128
// register FMAs per thread. The products run on CUDA cores in fp32 (bf16
// inputs are widened on load): tensor-core TF32 misses the fp32 bar, and
// a bf16 mma.sync / wgmma path is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // q rows (fwd, dQ role) or keys (dKV role) per block
constexpr int kTile = 64;    // keys per K/V tile, q rows per Q/dO tile
constexpr int kChunk = 32;   // scores held in registers per online-softmax step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// murmur3 fmix32 (fudanocr_tpu/ops/flash_attention.py:256 `_fmix`)
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// per-(image, head) seed (flash_attention.py:266 `_bh_seed`)
__device__ __forceinline__ uint32_t bh_seed(uint32_t seed, uint32_t b,
                                            uint32_t h, uint32_t heads) {
  return fmix32(seed ^ ((b * heads + h) * 0x9E3779B9u));
}

// keep decision of (q, k) (flash_attention.py:275 `_keep_mask`)
__device__ __forceinline__ bool keep_qk(uint32_t seed_bh, uint32_t q,
                                        uint32_t k, uint32_t L,
                                        uint32_t thresh) {
  return fmix32((q * L + k) ^ seed_bh) < thresh;
}

template <typename T, int DH>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* r) {
#pragma unroll
  for (int i = 0; i < DH; ++i) r[i] = to_f(p[i]);
}

// r . row, where row is a 16-byte aligned row of DH floats in shared memory
// (every thread of the block reads the same row: a broadcast)
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

// Copy kTile rows of DH features, starting at row r0 of a row-major
// matrix with row `stride` at src, into the (kTile, DH) tile dst.
template <typename T, int DH>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int64_t stride, int r0,
                                           float* dst) {
  for (int i = threadIdx.x; i < kTile * DH; i += kRows)
    dst[i] = to_f(src[(int64_t)(r0 + i / DH) * stride + i % DH]);
}

// An operand's base pointer and row stride (elements); an image's rows
// follow one another (batch stride L * row).
struct Operand {
  const void* p;
  int64_t row;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kRows)
attn_dropout_fwd_kernel(Operand q_op, Operand k_op, Operand v_op,
                        const int64_t* __restrict__ seed, T* __restrict__ out,
                        float* __restrict__ lse, int L, int H, float scale,
                        float inv_keep, uint32_t thresh) {
  __shared__ __align__(16) float ks[kTile * DH];
  __shared__ __align__(16) float vs[kTile * DH];
  const int b = blockIdx.z, h = blockIdx.y;
  const int q = blockIdx.x * kRows + threadIdx.x;
  const int D = H * DH;
  const T* qb = (const T*)q_op.p + (int64_t)b * L * q_op.row + h * DH;
  const T* kb = (const T*)k_op.p + (int64_t)b * L * k_op.row + h * DH;
  const T* vb = (const T*)v_op.p + (int64_t)b * L * v_op.row + h * DH;
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b, h, H);

  float qr[DH], acc[DH];
  load_row<T, DH>(qb + q * q_op.row, qr);
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    stage_tile<T, DH>(kb, k_op.row, k0, ks);
    stage_tile<T, DH>(vb, v_op.row, k0, vs);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = dot_sm<DH>(qr, ks + (c0 + j) * DH) * scale;
        cmax = fmaxf(cmax, s[j]);
      }
      const float mnew = fmaxf(m, cmax);
      const float alpha = __expf(m - mnew);   // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] *= alpha;
      const uint32_t ctr = (uint32_t)q * (uint32_t)L + (uint32_t)(k0 + c0);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = __expf(s[j] - mnew);
        l += p;
        const float pk = fmix32((ctr + j) ^ sbh) < thresh ? p : 0.f;
        axpy_sm<DH>(acc, pk, vs + (c0 + j) * DH);
      }
      m = mnew;
    }
  }
  const float f = inv_keep / l;
  T* o = out + ((int64_t)b * L + q) * D + h * DH;
#pragma unroll
  for (int i = 0; i < DH; ++i) store_f(o + i, acc[i] * f);
  lse[((int64_t)b * H + h) * L + q] = m + logf(l);
}

// A gradient's base pointer and row stride, as Operand.
struct Grad {
  void* p;
  int64_t row;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kRows)
attn_dropout_bwd_kernel(Operand q_op, Operand k_op, Operand v_op,
                        const T* __restrict__ out, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const int64_t* __restrict__ seed, Grad dq_g,
                        Grad dk_g, Grad dv_g, int L, int H, float scale,
                        float inv_keep, uint32_t thresh) {
  __shared__ __align__(16) float sa[kTile * DH];
  __shared__ __align__(16) float sb[kTile * DH];
  __shared__ float s_lse[kTile], s_di[kTile];
  const int b = blockIdx.z, h = blockIdx.y;
  const int nq = L / kRows;
  const int D = H * DH;
  const T* qb = (const T*)q_op.p + (int64_t)b * L * q_op.row + h * DH;
  const T* kb = (const T*)k_op.p + (int64_t)b * L * k_op.row + h * DH;
  const T* vb = (const T*)v_op.p + (int64_t)b * L * v_op.row + h * DH;
  const T* obase = out + (int64_t)b * L * D + h * DH;
  const T* dobase = dout + (int64_t)b * L * D + h * DH;
  const float* lse_bh = lse + ((int64_t)b * H + h) * L;
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b, h, H);

  if ((int)blockIdx.x < nq) {
    // dQ role: this thread's q row against every key
    const int q = blockIdx.x * kRows + threadIdx.x;
    float qr[DH], dor[DH], dq[DH];
    load_row<T, DH>(qb + q * q_op.row, qr);
    load_row<T, DH>(dobase + (int64_t)q * D, dor);
    load_row<T, DH>(obase + (int64_t)q * D, dq);   // o, to form D_q
    float di = 0.f;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      di = fmaf(dor[i], dq[i], di);
      dq[i] = 0.f;
    }
    const float lq = lse_bh[q];
    for (int k0 = 0; k0 < L; k0 += kTile) {
      __syncthreads();
      stage_tile<T, DH>(kb, k_op.row, k0, sa);
      stage_tile<T, DH>(vb, v_op.row, k0, sb);
      __syncthreads();
      const uint32_t ctr = (uint32_t)q * (uint32_t)L + (uint32_t)k0;
#pragma unroll 2
      for (int j = 0; j < kTile; ++j) {
        const float s = dot_sm<DH>(qr, sa + j * DH) * scale;
        const float p = __expf(s - lq);
        const float dpv = dot_sm<DH>(dor, sb + j * DH);
        const float dp =
            fmix32((ctr + j) ^ sbh) < thresh ? dpv * inv_keep : 0.f;
        axpy_sm<DH>(dq, p * (dp - di), sa + j * DH);
      }
    }
    T* dst = (T*)dq_g.p + ((int64_t)b * L + q) * dq_g.row + h * DH;
#pragma unroll
    for (int i = 0; i < DH; ++i) store_f(dst + i, dq[i] * scale);
  } else {
    // dK/dV role: this thread's key against every q row
    const int k = (blockIdx.x - nq) * kRows + threadIdx.x;
    float kr[DH], vr[DH], dk[DH], dv[DH];
    load_row<T, DH>(kb + k * k_op.row, kr);
    load_row<T, DH>(vb + k * v_op.row, vr);
#pragma unroll
    for (int i = 0; i < DH; ++i) dk[i] = dv[i] = 0.f;
    for (int q0 = 0; q0 < L; q0 += kTile) {
      __syncthreads();
      stage_tile<T, DH>(qb, q_op.row, q0, sa);
      stage_tile<T, DH>(dobase, D, q0, sb);
      if (threadIdx.x < kTile) {
        const int64_t r = (int64_t)(q0 + threadIdx.x) * D;
        float di = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i)
          di = fmaf(to_f(dobase[r + i]), to_f(obase[r + i]), di);
        s_di[threadIdx.x] = di;
        s_lse[threadIdx.x] = lse_bh[q0 + threadIdx.x];
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        const float s = dot_sm<DH>(kr, sa + i * DH) * scale;
        const float p = __expf(s - s_lse[i]);
        const float dpv = dot_sm<DH>(vr, sb + i * DH);
        const bool kept =
            keep_qk(sbh, (uint32_t)(q0 + i), (uint32_t)k, (uint32_t)L,
                    thresh);
        axpy_sm<DH>(dv, kept ? p * inv_keep : 0.f, sb + i * DH);
        const float dp = kept ? dpv * inv_keep : 0.f;
        axpy_sm<DH>(dk, p * (dp - s_di[i]), sa + i * DH);
      }
    }
    T* dkd = (T*)dk_g.p + ((int64_t)b * L + k) * dk_g.row + h * DH;
    T* dvd = (T*)dv_g.p + ((int64_t)b * L + k) * dv_g.row + h * DH;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      store_f(dkd + i, dk[i] * scale);
      store_f(dvd + i, dv[i]);
    }
  }
}

__global__ void attn_dropout_keep_kernel(const int64_t* __restrict__ seed,
                                         uint8_t* __restrict__ mask, int B,
                                         int H, int L, uint32_t thresh) {
  const int64_t n = (int64_t)B * H * L * L;
  const uint32_t s0 = (uint32_t)seed[0];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bh = i / ((int64_t)L * L);
    const int64_t qk = i % ((int64_t)L * L);
    const uint32_t sbh = bh_seed(s0, (uint32_t)(bh / H), (uint32_t)(bh % H),
                                 (uint32_t)H);
    mask[i] = keep_qk(sbh, (uint32_t)(qk / L), (uint32_t)(qk % L),
                      (uint32_t)L, thresh);
  }
}

bool shape_ok(int B, int L, int H, int dh) {
  return B >= 1 && H >= 1 && dh == 32 && L >= kRows && L % kRows == 0 &&
         B <= 65535 && H <= 65535;
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = success).
// q, k, v (B, L, H*dh) with row strides q_row, k_row, v_row (feature stride
// 1, an image's rows one after another): the fused layout (B4) passes the
// column slices of one (B, L, 3*H*dh) qkv, row stride 3*H*dh, the split
// layout (B11) three buffers. out (B, L, H*dh) and dout contiguous, lse
// (B, H, L) fp32; seed points at one int64 on the device holding the uint32
// seed; bf16 selects the element type of q/k/v/out/dout and the gradients
// (fp32 otherwise); dh must be 32 and L a multiple of 128.
extern "C" int attn_dropout_fwd(const void* q, const void* k, const void* v,
                                const void* seed, void* out, void* lse, int B,
                                int L, int H, int dh, int64_t q_row,
                                int64_t k_row, int64_t v_row, float scale,
                                float inv_keep, unsigned int thresh, int bf16,
                                void* stream) {
  if (!shape_ok(B, L, H, dh)) return (int)cudaErrorInvalidValue;
  const dim3 grid(L / kRows, H, B);
  const Operand qo{q, q_row}, ko{k, k_row}, vo{v, v_row};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    attn_dropout_fwd_kernel<__nv_bfloat16, 32><<<grid, kRows, 0, s>>>(
        qo, ko, vo, (const int64_t*)seed, (__nv_bfloat16*)out, (float*)lse, L,
        H, scale, inv_keep, thresh);
  else
    attn_dropout_fwd_kernel<float, 32><<<grid, kRows, 0, s>>>(
        qo, ko, vo, (const int64_t*)seed, (float*)out, (float*)lse, L, H,
        scale, inv_keep, thresh);
  return (int)cudaGetLastError();
}

// The gradients dq, dk, dv (B, L, H*dh) with their own row strides (the
// column slices of one dqkv for B4).
extern "C" int attn_dropout_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* seed, void* dq, void* dk,
    void* dv, int B, int L, int H, int dh, int64_t q_row, int64_t k_row,
    int64_t v_row, int64_t dq_row, int64_t dk_row, int64_t dv_row,
    float scale, float inv_keep, unsigned int thresh, int bf16,
    void* stream) {
  if (!shape_ok(B, L, H, dh)) return (int)cudaErrorInvalidValue;
  const dim3 grid(2 * (L / kRows), H, B);
  const Operand qo{q, q_row}, ko{k, k_row}, vo{v, v_row};
  const Grad dqg{dq, dq_row}, dkg{dk, dk_row}, dvg{dv, dv_row};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    attn_dropout_bwd_kernel<__nv_bfloat16, 32><<<grid, kRows, 0, s>>>(
        qo, ko, vo, (const __nv_bfloat16*)out, (const __nv_bfloat16*)dout,
        (const float*)lse, (const int64_t*)seed, dqg, dkg, dvg, L, H, scale,
        inv_keep, thresh);
  else
    attn_dropout_bwd_kernel<float, 32><<<grid, kRows, 0, s>>>(
        qo, ko, vo, (const float*)out, (const float*)dout, (const float*)lse,
        (const int64_t*)seed, dqg, dkg, dvg, L, H, scale, inv_keep, thresh);
  return (int)cudaGetLastError();
}

// The (B, H, L, L) uint8 keep mask, from the same __device__ hash the two
// kernels use (tests compare it with the plain version bit for bit).
extern "C" int attn_dropout_keep(const void* seed, void* mask, int B, int H,
                                 int L, unsigned int thresh, void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  attn_dropout_keep_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)seed, (uint8_t*)mask, B, H, L, thresh);
  return (int)cudaGetLastError();
}
