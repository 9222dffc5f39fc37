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
// In fp32 the same structure runs as CUDA-core FMAs with 4x4 register
// tiles and synchronous copies (tensor-core TF32 would miss the fp32
// tolerance).
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

// ------------------------------------------------- (b) attention + epilogue

// out = in @ W for a (64, 128) shared tile `in` (row stride kSA, values
// already rounded to T) and a row-major (128, N) weight W in global memory;
// calls store(row, col, sum) once per output after every thread is done
// reading `in`, so `store` may overwrite it.
//
// fp32: CUDA-core FMAs; thread (ty, tx) owns rows ty*4+i, columns tx+16*j;
// W is staged through `wst` in kWChunk-row chunks. (bf16: tile_matmul_mma.)
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

// Row-wise LN over the 128 columns of shared tiles of element type Buf
// (float, or bf16 in the tensor-core path) and row pitch P, one warp per
// row: dst[r] = round(LN(a[r] + b[r])). `a` is either a shared tile or,
// when x_tokens is set, the tokens-with-PE row read from global memory.
template <typename T, typename Buf, int P>
__device__ __forceinline__ void layer_norm_rows(
    const T* __restrict__ x_tokens, const T* __restrict__ pe, const Buf* a,
    const Buf* b, const float* __restrict__ g, const float* __restrict__ beta,
    float eps, Buf* dst, Buf* dst2, int q0, int L, size_t tok_base) {
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

template <int DH>
constexpr int fma_smem_bytes() {
  constexpr int attn = fma_scratch_floats<DH>();
  constexpr int epilogue = kT * kSA + kWChunk * kD;   // bufB + wst
  return (int)sizeof(float) *
         (kT * kSA + (attn > epilogue ? attn : epilogue));
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

template <typename T, int DH>
constexpr int smem_bytes() {
  return std::is_same<T, __nv_bfloat16>::value ? kMmaSmemBytes
                                               : fma_smem_bytes<DH>();
}

// bf16: at most 128 registers a thread, so that two blocks fit an SM
template <typename T>
constexpr int kMinBlocks = std::is_same<T, __nv_bfloat16>::value ? 2 : 1;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
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
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * kT;
  const size_t img = (size_t)blockIdx.y * L;   // first row of this image

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
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
  } else {
    float* bufA = smem;                 // (64, 128) working tile
    float* scratch = smem + kT * kSA;   // attention tiles, later bufB + wst
    float* bufB = scratch;              // x1, kept for the second residual
    float* wst = scratch + kT * kSA;    // weight staging
    attention_fma<T, DH>(qkv, img, q0, L, scratch, bufA);
    __syncthreads();  // attention scratch is free from here on

    // out = attn @ Wout + bout, in place in bufA
    tile_matmul_fma<T, kD>(bufA, wout, wst, [&](int r, int c, float v) {
      bufA[r * kSA + c] = rnd<T>(v + bout[c]);
    });
    __syncthreads();
    // x1 = LN1(x + out) into bufA and bufB
    layer_norm_rows<T, float, kSA>(tokens, pe, nullptr, bufA, ln1s, ln1b,
                                   eps, bufA, bufB, q0, L, (img + q0) * kC);
    // relu(x1 @ W1 + b1)
    tile_matmul_fma<T, kD>(bufA, w1, wst, [&](int r, int c, float v) {
      bufA[r * kSA + c] = rnd<T>(fmaxf(v + b1[c], 0.f));
    });
    // y = h @ W2 + b2
    tile_matmul_fma<T, kD>(bufA, w2, wst, [&](int r, int c, float v) {
      bufA[r * kSA + c] = rnd<T>(v + b2[c]);
    });
    __syncthreads();
    // x2 = LN2(x1 + y) into bufA
    layer_norm_rows<T, float, kSA>(nullptr, nullptr, bufB, bufA, ln2s, ln2b,
                                   eps, bufA, nullptr, q0, L, 0);
    // out = x2 @ Wp + bp, or with a residual res + (x2 @ Wp + bp) in fp32,
    // rounded once (the whole-SRB kernel's epilogue, fused_srb.py:119)
    tile_matmul_fma<T, kC>(bufA, wp, wst, [&](int r, int c, float v) {
      if (q0 + r >= L) return;
      const size_t i = (img + q0 + r) * kC + c;
      out[i] = from_f<T>(res != nullptr ? to_f(res[i]) + (v + bp[c])
                                        : v + bp[c]);
    });
  }
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
