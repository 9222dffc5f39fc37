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
//       online-softmax loop over 64-row K/V tiles with a true per-row max;
//       then, on the tile held in shared memory, out-proj, residual, LN1,
//       FFN, LN2 and the 64-d projection. Only (B, L, 64) is written.
// K and V of one image at L=1024 are 256 KB each in bf16, more than the
// 227 KB of shared memory a block may hold, hence the K/V tiling.
//
// What bounds it on this card: per image and enhancer about 0.70 GFLOP
// (2*L*(64*384 + 4*2*L*32 + 3*128^2 + 128*64) at L=1024, three quarters of
// it attention) against ~0.26 MB of essential bf16 token traffic plus
// 0.75 MB for the qkv scratch round trip: far above the ~295 flop/byte
// ridge, so it is compute-bound in the attention. What the design does
// about it: in bf16, every product (qkv, QK^T, PV, out-proj, FFN, proj)
// runs on the tensor cores through mma.sync m16n8k16 with fp32
// accumulators, the online softmax working on the accumulator fragments;
// tiles move with 16-byte copies and B fragments come through
// ldmatrix.trans. No wgmma, TMA or pipelining yet (later work), and the
// weights come through L2 into shared memory per block. In fp32 the same
// structure runs as CUDA-core FMAs with 4x4 register tiles (tensor-core
// TF32 would miss the fp32 tolerance).
//
// Unlike the TPU kernel it keeps the per-row softmax max (no +-100 clip),
// uses expf (__expf in bf16), and scales the fp32 scores rather than q before its cast. In
// bf16 the probabilities are rounded to bf16 for the PV product (as the
// JAX kernel does); the plain version keeps them fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"

namespace {

constexpr int kD = 128;        // model width: 64 token + 64 PE channels
constexpr int kC = 64;         // token channels in and out
constexpr int kQKV = 3 * kD;   // fused q|k|v width
constexpr int kT = 64;         // rows per q tile and per k/v tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kSA = kD + 4;    // padded row stride of the (64, 128) tiles
constexpr int kWChunk = 32;    // weight rows staged in shared memory at once

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

// sum / max over the 16 lanes of a half warp (one row group)
__device__ __forceinline__ float group_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float group_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- (a) qkv
// fp32: CUDA-core FMAs. grid (ceil(rows/64), 6): each block computes a
// 64-row x 64-column slab of the (rows, 384) qkv. Thread (ty, tx) owns
// rows ty*4+i, columns tx+16*j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qkv_proj_kernel(const T* __restrict__ tokens, const T* __restrict__ wtop,
                const float* __restrict__ peqkv, T* __restrict__ qkv,
                int rows, int L) {
  __shared__ float xs[kT][kC + 1];
  __shared__ float ws[kC][kT];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row0 = blockIdx.x * kT, col0 = blockIdx.y * kT;
  for (int e = tid; e < kT * kC; e += kThreads) {
    const int r = e / kC, k = e % kC;
    xs[r][k] = row0 + r < rows ? to_f(tokens[(size_t)(row0 + r) * kC + k])
                               : 0.f;
    ws[r][k] = to_f(wtop[(size_t)r * kQKV + col0 + k]);  // r is the k index
  }
  __syncthreads();
  float acc[4][4] = {};
#pragma unroll 8
  for (int k = 0; k < kC; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= rows) continue;
    const int l = row % L;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      qkv[(size_t)row * kQKV + col] =
          from_f<T>(acc[i][j] + peqkv[(size_t)l * kQKV + col]);
    }
  }
}

// bf16: mma.sync m16n8k16. grid (ceil(rows/64), 3): a block computes
// 64 rows x 128 columns; warp w owns rows (w%4)*16..+15 and the column half
// w/4. Tokens and the W slab are staged row-major with 16-byte copies.
__global__ void __launch_bounds__(kThreads)
qkv_proj_mma_kernel(const __nv_bfloat16* __restrict__ tokens,
                    const __nv_bfloat16* __restrict__ wtop,
                    const float* __restrict__ peqkv,
                    __nv_bfloat16* __restrict__ qkv, int rows, int L) {
  constexpr int SX = kC + 8, SW = kD + 8;   // bf16 row strides
  __shared__ __align__(16) __nv_bfloat16 xs[kT * SX];
  __shared__ __align__(16) __nv_bfloat16 ws[kC * SW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kT, col0 = blockIdx.y * kD;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 64;
  for (int e = tid; e < kT * kC / 8; e += kThreads) {
    const int r = e / (kC / 8), c8 = e % (kC / 8);
    *reinterpret_cast<uint4*>(xs + r * SX + c8 * 8) =
        row0 + r < rows ? *reinterpret_cast<const uint4*>(
                              tokens + (size_t)(row0 + r) * kC + c8 * 8)
                        : make_uint4(0, 0, 0, 0);
  }
  for (int e = tid; e < kC * kD / 8; e += kThreads) {
    const int k = e / (kD / 8), c8 = e % (kD / 8);
    *reinterpret_cast<uint4*>(ws + k * SW + c8 * 8) =
        *reinterpret_cast<const uint4*>(wtop + (size_t)k * kQKV + col0 +
                                        c8 * 8);
  }
  __syncthreads();
  float acc[8][4] = {};
#pragma unroll
  for (int ks = 0; ks < kC / 16; ++ks) {
    const __nv_bfloat16* a = xs + (r0 + g) * SX + ks * 16 + 2 * t;
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * SX), ld32(a + 8),
                            ld32(a + 8 * SX + 8)};
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * SW + c0 + n * 8 +
                               (lane >> 4) * 8);
      mma_bf16(acc[n], af, b[0], b[1]);
      mma_bf16(acc[n + 1], af, b[2], b[3]);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + r0 + g + 8 * hr;
    if (row >= rows) continue;
    const float* pq = peqkv + (size_t)(row % L) * kQKV + col0 + c0 + 2 * t;
    __nv_bfloat16* dst = qkv + (size_t)row * kQKV + col0 + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * hr] + pq[n * 8], acc[n][2 * hr + 1] + pq[n * 8 + 1]);
  }
}

// ------------------------------------------------- (b) attention + epilogue

// out = in @ W for a (64, 128) shared tile `in` (row stride kSA, values
// already rounded to T) and a row-major (128, N) weight W in global memory;
// calls store(row, col, sum) once per output after every thread is done
// reading `in`, so `store` may overwrite it.
//
// fp32: CUDA-core FMAs; thread (ty, tx) owns rows ty*4+i, columns tx+16*j;
// W is staged through `wst` in kWChunk-row chunks.
template <typename T, int N, typename Store>
__device__ __forceinline__ void tile_matmul_fma(const float* in,
                                                const T* __restrict__ W,
                                                float* wst, Store store) {
  constexpr int NC = N / 16;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][NC] = {};
  for (int k0 = 0; k0 < kD; k0 += kWChunk) {
    __syncthreads();
    for (int e = tid; e < kWChunk * N; e += kThreads)
      wst[e] = to_f(W[(size_t)k0 * N + e]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kWChunk; ++kk) {
      float a[4], b[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = in[(ty * 4 + i) * kSA + k0 + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) b[j] = wst[kk * N + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();  // every thread is done reading `in`
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) store(ty * 4 + i, tx + 16 * j, acc[i][j]);
}

// bf16: mma.sync m16n8k16; warp w owns rows (w%4)*16..+15 and the column
// half w/4. W is staged row-major in 64-row chunks with 16-byte copies and
// read as B fragments by ldmatrix.trans; `in` is exact in bf16, so packing
// its fp32 values loses nothing.

template <int N, typename Store>
__device__ __forceinline__ void tile_matmul_mma(
    const float* in, const __nv_bfloat16* __restrict__ W, float* wst_f,
    Store store) {
  constexpr int NT = N / 16;   // n-tiles of 8 per warp (half the columns)
  constexpr int SW = N + 8;    // bf16 row stride of the staged W chunk
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(wst_f);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * (N / 2);
  float acc[NT][4] = {};
  for (int k0 = 0; k0 < kD; k0 += 64) {
    __syncthreads();
    for (int e = tid; e < 64 * N / 8; e += kThreads) {
      const int kk = e / (N / 8), c8 = e % (N / 8);
      *reinterpret_cast<uint4*>(ws + kk * SW + c8 * 8) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + kk) * N + c8 * 8);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* a = in + (r0 + g) * kSA + k0 + ks * 16 + 2 * t;
      const uint32_t af[4] = {pack_bf16(a[0], a[1]),
                              pack_bf16(a[8 * kSA], a[8 * kSA + 1]),
                              pack_bf16(a[8], a[9]),
                              pack_bf16(a[8 * kSA + 8], a[8 * kSA + 9])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * SW + c0 + n * 8 +
                                 (lane >> 4) * 8);
        mma_bf16(acc[n], af, b[0], b[1]);
        mma_bf16(acc[n + 1], af, b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every thread is done reading `in`
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store(r0 + g + 8 * (c >> 1), c0 + n * 8 + 2 * t + (c & 1), acc[n][c]);
}

template <typename T, int N, typename Store>
__device__ __forceinline__ void tile_matmul(const float* in,
                                            const T* __restrict__ W,
                                            float* wst, Store store) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    tile_matmul_mma<N>(in, W, wst, store);
  else
    tile_matmul_fma<T, N>(in, W, wst, store);
}

// Row-wise LN over the 128 columns of shared tiles, one warp per row:
// dst[r] = round(LN(a[r] + b[r])). `a` is either a shared tile or, when
// x_tokens is set, the tokens-with-PE row read from global memory.
template <typename T>
__device__ __forceinline__ void layer_norm_rows(
    const T* __restrict__ x_tokens, const T* __restrict__ pe, const float* a,
    const float* b, const float* __restrict__ g, const float* __restrict__ beta,
    float eps, float* dst, float* dst2, int q0, int L, size_t tok_base) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kT; r += kThreads / 32) {
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
        xa = a[r * kSA + c];
      }
      v[q] = xa + b[r * kSA + c];
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
      const float y = rnd<T>(v[q] / denom * g[c] + beta[c]);
      dst[r * kSA + c] = y;
      if (dst2 != nullptr) dst2[r * kSA + c] = y;
    }
  }
}

// ---- attention, fp32: CUDA-core FMAs with 4x4 register tiles -----------
// Thread (ty, tx) owns q rows ty*4+i and, per K/V tile, key columns
// tx+16*j; the 16 threads of a row group reduce the softmax statistics with
// half-warp shuffles. One head at a time; writes round(attn) into bufA.
template <int DH>
constexpr int fma_scratch_floats() {
  return 3 * kT * (DH + 1) + kT * (kT + 1);
}

template <typename T, int DH>
__device__ __forceinline__ void attention_fma(const T* __restrict__ qkv,
                                              size_t img, int q0, int L,
                                              float* scratch, float* bufA) {
  constexpr int kHeads = kD / DH;
  constexpr int OC = DH / 16;     // attention output columns per thread
  constexpr int SQ = DH + 1;      // padded row stride of q/k/v tiles
  constexpr int SP = kT + 1;      // padded row stride of the p tile
  float* qs = scratch;
  float* ks = qs + kT * SQ;
  float* vs = ks + kT * SQ;
  float* ps = vs + kT * SQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float scale = 1.f / sqrtf((float)DH);

  for (int h = 0; h < kHeads; ++h) {
    __syncthreads();  // previous head is done with qs
    for (int e = tid; e < kT * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      qs[r * SQ + d] = q0 + r < L
          ? to_f(qkv[(img + q0 + r) * kQKV + h * DH + d]) : 0.f;
    }
    float m[4], lsum[4], o[4][OC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      lsum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < OC; ++j) o[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < L; k0 += kT) {
      __syncthreads();  // previous tile's ks/vs/ps are consumed
      for (int e = tid; e < kT * DH; e += kThreads) {
        const int r = e / DH, d = e % DH;
        const bool ok = k0 + r < L;
        const size_t base = (img + k0 + r) * kQKV + h * DH + d;
        ks[r * SQ + d] = ok ? to_f(qkv[base + kD]) : 0.f;
        vs[r * SQ + d] = ok ? to_f(qkv[base + 2 * kD]) : 0.f;
      }
      __syncthreads();
      float s[4][4] = {};
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * SQ + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * SQ + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = k0 + tx + 16 * j < L ? s[i][j] * scale : -INFINITY;
          mt = fmaxf(mt, s[i][j]);
        }
        // column 0 of the first tile is always valid, so m_new is finite
        const float m_new = fmaxf(m[i], group_max(mt));
        const float alpha = expf(m[i] - m_new);
        float pt = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          pt += p;
          ps[(ty * 4 + i) * SP + tx + 16 * j] = p;
        }
        lsum[i] = lsum[i] * alpha + group_sum(pt);
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < OC; ++j) o[i][j] *= alpha;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kT; ++kk) {
        float a[4], b[OC];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ps[(ty * 4 + i) * SP + kk];
#pragma unroll
        for (int j = 0; j < OC; ++j) b[j] = vs[kk * SQ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < OC; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < OC; ++j)
        bufA[(ty * 4 + i) * kSA + h * DH + tx + 16 * j] =
            rnd<T>(o[i][j] / lsum[i]);
  }
}

// ---- attention, bf16: tensor cores through mma.sync m16n8k16 -------------
// Warp w owns q rows (w%4)*16..+15 and heads w/4, w/4+2, ...: QK^T and PV
// run as bf16 mma with fp32 accumulators, the online softmax on the
// accumulator fragments (a row's values sit in the 4 lanes of a quad).
// Shared memory holds the q tile and one 64-key K and V tile of every head
// in bf16, copied with 16-byte stores; K's B fragments are 32-bit loads,
// V's come through ldmatrix.trans, and the row pad keeps both free of bank
// conflicts. P is rounded to bf16 for the PV product; its row sums stay
// fp32. The exponentials use the fast __expf: its error is far below
// bf16's.
constexpr int kSQ16 = kD + 8;  // bf16 row stride of the q, k and v tiles
constexpr int kMmaScratchFloats = 3 * kT * kSQ16 / 2;

// 16-byte rows [r][0..127] of q (part 0), k (1) or v (2) of a 64-row tile
// starting at row0; rows at or past L read as zeros
__device__ __forceinline__ uint4 load_qkv8(const __nv_bfloat16* __restrict__ qkv,
                                           size_t img, int row0, int L,
                                           int part, int r, int c8) {
  if (row0 + r >= L) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(
      qkv + (img + row0 + r) * kQKV + part * kD + c8 * 8);
}

template <int DH>
__device__ __forceinline__ void attention_mma(
    const __nv_bfloat16* __restrict__ qkv, size_t img, int q0, int L,
    float* scratch, float* bufA) {
  constexpr int kHeads = kD / DH;
  constexpr int HPW = kHeads / 2;   // heads per warp (8 warps, 4 row groups)
  constexpr int KS = DH / 16;       // k-steps of the QK^T product
  constexpr int NO = DH / 8;        // n-tiles of the PV product
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* ks = qs + kT * kSQ16;
  __nv_bfloat16* vs = ks + kT * kSQ16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma group and lane in it
  const int r0 = (warp & 3) * 16, hsel = warp >> 2;
  const float scale = 1.f / sqrtf((float)DH);

  for (int e = tid; e < kT * kD / 8; e += kThreads) {
    const int r = e / (kD / 8), c8 = e % (kD / 8);
    *reinterpret_cast<uint4*>(qs + r * kSQ16 + c8 * 8) =
        load_qkv8(qkv, img, q0, L, 0, r, c8);
  }
  __syncthreads();
  uint32_t qa[HPW][KS][4];
  float o[HPW][NO][4], m[HPW][2], l[HPW][2];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = hsel + 2 * i;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const __nv_bfloat16* q = qs + (r0 + g) * kSQ16 + h * DH + k * 16 + 2 * t;
      qa[i][k][0] = ld32(q);
      qa[i][k][1] = ld32(q + 8 * kSQ16);
      qa[i][k][2] = ld32(q + 8);
      qa[i][k][3] = ld32(q + 8 * kSQ16 + 8);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][n][c] = 0.f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kT) {
    __syncthreads();  // previous tile is consumed
    for (int e = tid; e < kT * kD / 8; e += kThreads) {
      const int r = e / (kD / 8), c8 = e % (kD / 8);
      *reinterpret_cast<uint4*>(ks + r * kSQ16 + c8 * 8) =
          load_qkv8(qkv, img, k0, L, 1, r, c8);
      *reinterpret_cast<uint4*>(vs + r * kSQ16 + c8 * 8) =
          load_qkv8(qkv, img, k0, L, 2, r, c8);
    }
    __syncthreads();
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
              ks + (n * 8 + g) * kSQ16 + h * DH + k * 16 + 2 * t;
          mma_bf16(s[n], qa[i][k], ld32(kp), ld32(kp + 8));
        }
      }
      // online softmax; this lane holds rows g (c = 0, 1) and g + 8
      // (c = 2, 3), key columns n*8 + 2t + {0, 1}
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kT / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = k0 + n * 8 + 2 * t + (c & 1) < L;
          s[n][c] = ok ? s[n][c] * scale : -INFINITY;
          mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        // column 0 of the first tile is always valid, so this is finite
        const float m_new = fmaxf(m[i][rr], mx[rr]);
        alpha[rr] = __expf(m[i][rr] - m_new);
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
      // O += P V: the accumulators of key tiles 2j, 2j+1 are the A
      // fragment of k-step j
#pragma unroll
      for (int j = 0; j < kT / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (j * 16 + (lane & 15)) * kSQ16 + h * DH +
                                   n * 8 + (lane >> 4) * 8);
          mma_bf16(o[i][n], pa, b[0], b[1]);
          mma_bf16(o[i][n + 1], pa, b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = hsel + 2 * i;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + g + 8 * (c >> 1);
        bufA[row * kSA + h * DH + n * 8 + 2 * t + (c & 1)] =
            rnd<__nv_bfloat16>(o[i][n][c] / l[i][c >> 1]);
      }
  }
}

template <typename T, int DH>
constexpr int smem_bytes() {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int attn = bf16 ? kMmaScratchFloats : fma_scratch_floats<DH>();
  constexpr int epilogue =
      kT * kSA + (bf16 ? 64 * (kD + 8) / 2 : kWChunk * kD);  // bufB + wst
  return (int)sizeof(float) *
         (kT * kSA + (attn > epilogue ? attn : epilogue));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  float* bufA = smem;                 // (64, 128) working tile
  float* scratch = smem + kT * kSA;   // attention tiles, later bufB + wst
  float* bufB = scratch;              // x1, kept for the second residual
  float* wst = scratch + kT * kSA;    // weight staging

  const int q0 = blockIdx.x * kT;
  const size_t img = (size_t)blockIdx.y * L;   // first row of this image

  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    attention_mma<DH>(qkv, img, q0, L, scratch, bufA);
  else
    attention_fma<T, DH>(qkv, img, q0, L, scratch, bufA);
  __syncthreads();  // attention scratch is free from here on

  // out = attn @ Wout + bout, in place in bufA
  tile_matmul<T, kD>(bufA, wout, wst, [&](int r, int c, float v) {
    bufA[r * kSA + c] = rnd<T>(v + bout[c]);
  });
  __syncthreads();
  // x1 = LN1(x + out) into bufA and bufB
  layer_norm_rows<T>(tokens, pe, nullptr, bufA, ln1s, ln1b, eps, bufA, bufB,
                     q0, L, (img + q0) * kC);
  // relu(x1 @ W1 + b1)
  tile_matmul<T, kD>(bufA, w1, wst, [&](int r, int c, float v) {
    bufA[r * kSA + c] = rnd<T>(fmaxf(v + b1[c], 0.f));
  });
  // y = h @ W2 + b2
  tile_matmul<T, kD>(bufA, w2, wst, [&](int r, int c, float v) {
    bufA[r * kSA + c] = rnd<T>(v + b2[c]);
  });
  __syncthreads();
  // x2 = LN2(x1 + y) into bufA
  layer_norm_rows<T>(nullptr, nullptr, bufB, bufA, ln2s, ln2b, eps, bufA,
                     nullptr, q0, L, 0);
  // out = x2 @ Wp + bp, or with a residual res + (x2 @ Wp + bp) in fp32,
  // rounded once (the whole-SRB kernel's epilogue, fused_srb.py:119)
  tile_matmul<T, kC>(bufA, wp, wst, [&](int r, int c, float v) {
    if (q0 + r >= L) return;
    const size_t i = (img + q0 + r) * kC + c;
    out[i] = from_f<T>(res != nullptr ? to_f(res[i]) + (v + bp[c])
                                      : v + bp[c]);
  });
}

template <typename T>
int launch_qkv(const void* tokens, const void* wtop, const void* peqkv,
               void* qkv, int rows, int L, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    dim3 grid((rows + kT - 1) / kT, kQKV / kD);
    qkv_proj_mma_kernel<<<grid, kThreads, 0, stream>>>(
        (const T*)tokens, (const T*)wtop, (const float*)peqkv, (T*)qkv, rows,
        L);
  } else {
    dim3 grid((rows + kT - 1) / kT, kQKV / kT);
    qkv_proj_kernel<T><<<grid, kThreads, 0, stream>>>(
        (const T*)tokens, (const T*)wtop, (const float*)peqkv, (T*)qkv, rows,
        L);
  }
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_attn(const void* const* p, void* out, int B, int L, float eps,
                cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_epilogue_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kT - 1) / kT, B);
  attn_epilogue_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6],
      (const T*)p[7], (const float*)p[8], (const T*)p[9], (const float*)p[10],
      (const float*)p[11], (const float*)p[12], (const T*)p[13],
      (const float*)p[14], (const T*)p[15], (T*)out, L, eps);
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
