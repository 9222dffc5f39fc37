// Softmax attention over strided q/k/v/o, unmasked or region-masked,
// forward and backward, hand-written for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// Replaces five Pallas TPU kernels of the JAX package (fudanocr_tpu/ops/):
//   * region_attention.py `_plain_fwd` (:280, pallas_call :284) and its
//     backward `_plain_bwd` (:306, pallas_call :311), reached through
//     `packed_flash_mha` (:340): lane-packed q (B, Lq, H*dh) and k/v
//     (B, Lkv, H*dh), head h in columns [h*dh, (h+1)*dh);
//   * region_attention.py `_region_fwd` (:167, pallas_call :177) and its
//     backward `_region_bwd` (:201, pallas_call :208), reached through
//     `region_flash_mha` (:239): the same packed layout plus (B, Lq) and
//     (B, Lkv) fp32 region ids;
//   * flash_attention.py `_mha_full` (:119, pallas_call :122) and the
//     online-softmax `_flash_mha_impl` (:653, pallas_call :682), reached
//     through `flash_mha` (:620): (B, H, L, dh) operands (forward only: the
//     JAX VJP of `flash_mha` is plain XLA).
// The same forward also serves `flash_mha_qkv_packed` (flash_attention.py
// :220, B3: column slices of one (B, L, 3*H*dh) qkv) and `flash_mha_packed`
// (:164, B10: separate q, k, v) through the wrappers of
// fudanocr_tpu_torch/ops/flash_attention.py.
// They compute one function and differ only in layout and the mask, so one
// kernel family takes batch, head and row strides (in elements; the
// feature stride is 1) for each operand and a compile-time MASKED flag. The
// Python wrappers, with their launch counters, the autograd Functions and
// the plain PyTorch versions, are `packed_flash_mha` and `region_flash_mha`
// in fudanocr_tpu_torch/ops/region_attention.py and `flash_mha` in
// fudanocr_tpu_torch/ops/flash_attention.py.
//
// Per (image b, head h), with scale = 1/sqrt(dh):
//   s = q k^T * scale (fp32),  o = softmax_rows(s) v,
// row max subtracted, fp32 statistics and accumulation, o in the input type
// (fp32 or bf16). MASKED adds the det-guided suppression of the reference
// (cascade_mit.py calculate_mask):
//   s_ij = (q_i . k_j * scale) + (rq_i == rkv_j ? -1e10 : 0),
// rounded after the product and again after the sum, before the row max,
// as the JAX kernel does. In fp32 the spacing near 1e10 is 1024, so every
// |s| < 512 suppressed score becomes exactly -1e10: a row whose keys are
// all suppressed is uniform (o = mean of v), not the softmax of its scores.
// The kernels never skip a suppressed key and start the running max at
// -inf, so such a row comes out as the plain version computes it.
//
// Every kernel streams the other side through shared memory in tiles of 64
// rows: K and V of one head do not fit there at the segmentation shapes
// (Lkv = 1024, dh = 32, fp32: 256 KB; 1 MB at Lkv = 4096). The forward keeps
// an online softmax (per tile the running max, the running denominator and
// the accumulator are rescaled once), so nothing of size Lq x Lkv touches
// device memory. The training forward (STATS) also writes, per (image,
// head, q row), the row max m and 1/l (l the denominator), and o in fp32.
// One log-sum-exp would not do: for a fully suppressed row m = -1e10, and
// m + log(l) rounds back to -1e10 in fp32, so exp(s - lse) would give 1
// where the answer is 1/Lkv.
//
// The backward (the JAX `_bwd_body`: probs = softmax(s + M),
// dv = probs^T dO, dp = dO v^T, ds = probs * (dp - rowsum(dp * probs)),
// dq = ds k * scale, dk = ds^T q * scale) is FlashAttention-2's split:
// p_ij = exp(s_ij - m_i) / l_i is recomputed from the saved statistics with
// the forward's rounding, and rowsum(dp * probs) = D_i = dO_i . o_i from the
// saved fp32 o. Three launches, no atomics, deterministic:
//   1. dQ: the q rows against every key (K/V tiles in shared memory); it
//      also writes D_i for launch 2;
//   2. dK/dV partials: the keys against a slice of the q rows (Q/dO tiles
//      in shared memory). One pass over all of Lq would give B*H*Lkv/128
//      blocks, 16 at stage 0 of both seg recipes against 132 SMs, so Lq is
//      split across blocks (about 528 blocks in all) and each slice writes
//      fp32 partial sums;
//   3. the partials summed in a fixed order, dk scaled, both rounded to the
//      input type.
//
// What bounds it on this card: the forward does 4*B*H*Lq*Lkv*dh flops (two
// products), the backward 10*B*H*Lq*Lkv*dh (the JAX CostEstimate: s, dv, dp,
// dq, dk), against each operand read once and each result written once. At
// the det recipe's stage 0 (B = 2, Lq = 65,536, Lkv = 1024, dh = 32, fp32)
// the backward's 42.9 GFLOP take 0.64 ms at the CUDA cores' 67 TFLOP/s and
// 0.26 ms as three TF32 products at the tensor cores' 495 TFLOP/s, against
// ~0.01 ms for its bytes: the products set the bound.
//
// fp32: the tensor cores in split TF32 (3xTF32). Every fp32 call runs
// `attn_fwd_tf32x3_kernel` (csrc/unmasked_attention_fwd_tf32x3.cu;
// unmasked, MASKED and STATS; B5, B6, B7 and, through B7's wrappers, B3 and
// B10) or, for the backward, `attn_bwd_dq_tf32x3_kernel` and
// `attn_bwd_dkv_tf32x3_kernel` (csrc/unmasked_attention_bwd_tf32x3.cu),
// then this file's reduce; their helpers are csrc/tf32x3.cuh. No fp32
// instantiation of the CUDA-core kernels below is built. (Three sources,
// so that nvcc compiles them in parallel.) One TF32 product
// (mma.sync m16n8k8 .tf32: 10 explicit mantissa bits, products exact,
// fp32 sums) misses the fp32 bar by two orders: its operands carry 2^-11
// relative error, ~5e-4 in o at standard-normal inputs against the 1e-5
// bar. The split keeps fp32's precision: each operand x becomes hi =
// tf32(x) (cvt.rna) plus lo = tf32(x - hi), so x - hi - lo is below 2^-22 |x|,
// and
//   a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b
// drops only lo_a lo_b (< 2^-22 |a b|): three TF32 products, ~165 TFLOP/s
// of fp32-accurate product at the 495 TFLOP/s TF32 peak, 2.5x the CUDA
// cores' 67. The CPU rounding model (tests/torch_attention_cases.py
// `tf32x3_attention_model`, held against the JAX kernels in
// tests/test_torch_tf32x3_rounding.py) stays within the fp32 bar where
// one product does not. What the tensor cores add, and the design answers:
// they round each mma's sum toward zero (about -0.3 ulp per mma on
// average on an H100, scripts/tf32_mma_rounding.py), a bias that grows
// with the number of mmas summed into one accumulator. So every sum starts
// afresh for each 64-row tile and is added to the running fp32 sum on the
// CUDA cores (rounded to nearest), and within a tile the two small
// products of every k-step are summed before the large ones: S takes dh/8
// truncations of its own size, never one per tile of Lkv.
// The rounding points are the CUDA-core kernels': s = fp32 product times
// scale with __fmul_rn, MASKED adds -1e10 with __fadd_rn, the running max
// from -inf, p = exp(s - m) in fp32, l in fp32, o = acc * (1/l); STATS
// writes m, 1/l and o in fp32. The design is B1's and the bf16 forward's
// mma.sync loop (below) on fp32 tiles:
//   * one block of 8 warps per 128 rows; each warp owns 16 rows (q rows,
//     or keys in the dK/dV pass) and keeps their A fragments in registers
//     for the whole loop, split into hi and lo once (the forward's Q, the
//     dQ pass's Q and dO, the dK/dV pass's K and V). Where 128-row blocks
//     would number fewer than two per SM (stage and level 3, B 3: 192),
//     the forward takes blocks of 4 warps and 64 rows: ~10 % faster there
//     (scripts/time_seg_attention.py, variant rows128). At dh = 32 every
//     kernel is held to 128 registers, 2 blocks an SM (ptxas spills up to
//     172 bytes in the dK/dV pass): against 1 block (variant one_block)
//     the forward is ~11 % faster at stage 0 and ~9 % slower at stage 3,
//     the backward within 3 %; at dh = 64, off every path, one block
//     takes 253-255 registers (the backward passes spill up to 52 bytes);
//   * the other side's 64-row tiles arrive fp32 through 16-byte cp.async
//     copies (4-byte ones where a pointer or stride rules those out),
//     double-buffered, and are split into hi and lo once per block, in
//     place, not once per warp: eight warps splitting the same tile would
//     add ~12 CUDA-core operations a score at dh = 32, twice the softmax.
//     Rows are padded to a pitch of dh + 4 floats (4 mod 32), so every
//     fragment load below is free of bank conflicts; two barriers a tile
//     (the tile is in; it is split);
//   * P (or dS) as the A operand straight from the accumulators: the m16n8
//     C fragment holds keys 2t and 2t + 1 of its 8, the m16n8k8 A fragment
//     wants k = t and t + 4, so the keys are relabelled (a0 = c0, a1 = c2,
//     a2 = c1, a3 = c3) and the B fragment of V (or K, Q, dO) is read from
//     tile rows 2t and 2t + 1; the product sums over keys, so the order is
//     free;
//   * the backward passes take the 64-row tile in chunks of 16 rows (S and
//     dP of a chunk in 16 registers: the statistics are known, so no row
//     reduction spans the tile) and keep their running sums (dQ; dK and
//     dV) in shared memory, each element owned by one lane, added to once
//     per tile.
//
// bf16: the unmasked inference forward (`attn_fwd_mma_kernel`: B7, B3 and
// B10 on the packed layout, B5 on the head-major one) runs on the tensor
// cores; every bf16 call without region ids and without STATS runs it. It
// computes the JAX kernels' function at their rounding points
// (region_attention.py `_fwd_body` :63-81, flash_attention.py
// `_packed_kernel` :136-160 and the online `_flash_kernel` :46-79):
//   s = fp32(q k^T) * scale, m the running row max, p = exp(s - m) in fp32,
//   l = sum p in fp32, the rescale exp(m_old - m_new),
//   o = (bf16(p) v, accumulated in fp32) / l, rounded to bf16.
// What bounds it: 4*B*H*Lq*Lkv*dh flops on the tensor cores (989 TFLOP/s
// bf16) against 2 bytes per q, k, v and o element; at TBSRN's shape (B 256,
// L 1024, 4 heads of 32) 137 GFLOP take 0.139 ms, the bytes 0.03 ms. At
// dh = 32 each score costs 4*dh = 128 tensor-core flops but also a scale,
// a max, a subtraction, an exponential and an add on the CUDA cores, so the
// softmax, not the products, is what the design has to keep lean. The
// design is FlashAttention-2's forward on mma.sync m16n8k16 (bf16 in, fp32
// accumulators), B1's attention loop (csrc/fused_enhancer.cu
// `attention_mma`) on strided operands:
//   * one block of 8 warps per (128-row q tile, head, image); each warp
//     owns 16 q rows and keeps their A fragments in registers for the whole
//     key loop;
//   * 64-key tiles of K and V stay bf16 in shared memory, rows padded by 8
//     elements so the fragment loads are free of bank conflicts, double-
//     buffered with 16-byte cp.async copies: tile j + 1 loads while tile j
//     is computed. The q tile is staged once through the second buffer.
//     Where a base pointer or a stride rules out 16-byte copies (a column
//     slice at an odd element offset), a compile-time variant of the same
//     kernel copies 2 bytes at a time, synchronously;
//   * S = Q K^T as dh/16 k-steps x 8 n-tiles per warp, K's B fragments as
//     32-bit loads from the row-major (key, d) tile;
//   * the online softmax on the accumulator fragments: a row's values sit
//     in the 4 lanes of a quad and reduce with two xor shuffles;
//   * P rounded to bf16 and repacked in registers: the m16n8 C layout of
//     two adjacent key n-tiles is the m16n8k16 A layout, so P never goes
//     through shared memory; V's B fragments come through ldmatrix.trans;
//   * o / l rounded to bf16 and stored through the output's own strides.
// No wgmma and no TMA: mma.sync at 8 warps per block is the proven base
// (B1); warp-group products are later work.
// The bf16 MASKED forward, STATS forward and backward, which no path
// reaches in bf16, still widen bf16 to fp32 on the CUDA cores
// (`attn_fwd_kernel`, `attn_bwd_dq_kernel`, `attn_bwd_dkv_kernel`): one
// block of 128 threads per 128 rows, one thread per q row (or key) holding
// its row and its accumulator in registers, each shared-memory row read as
// a broadcast feeding one FMA per feature, tiles staged element by element.
// A bf16 value is exact in TF32 (its low part is zero), so these calls can
// move to the tf32x3 kernels with one product each at today's bf16
// semantics (ROADMAP B-R2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "unmasked_attention.cuh"

namespace {

using namespace seg_attn;

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

template <typename T, int DH>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* r) {
#pragma unroll
  for (int i = 0; i < DH; ++i) r[i] = to_f(p[i]);
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

// the scaled score of one (q, key) pair, with the forward's rounding: the
// masked sum is rounded twice (product, then sum), never contracted into
// one FMA, to keep the JAX kernel's rounding
template <bool MASKED>
__device__ __forceinline__ float score(float d, float scale, float rid,
                                       float kid) {
  return MASKED ? __fadd_rn(__fmul_rn(d, scale), rid == kid ? kNeg : 0.f)
                : d * scale;
}

// STATS: o is fp32 and the row max and 1/denominator are written to
// stat_m / stat_inv at ((b * H + h) * Lq + row)
template <typename T, typename TO, int DH, bool MASKED, bool STATS>
__global__ void __launch_bounds__(kRows)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, TO* __restrict__ o,
                const float* __restrict__ rq, const float* __restrict__ rkv,
                float* __restrict__ stat_m, float* __restrict__ stat_inv,
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
  load_row<T, DH>(q + b * sq.b + h * sq.h + row * sq.r, qr);
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
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
        s[j] = score<MASKED>(dot_sm<DH>(qr, ks + (c0 + j) * DH), scale, rid,
                             MASKED ? ids[c0 + j] : 0.f);
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
  TO* op = o + b * so.b + h * so.h + row * so.r;
#pragma unroll
  for (int i = 0; i < DH; ++i) store_f(op + i, acc[i] * inv);
  if (STATS) {
    const int64_t r = ((int64_t)b * gridDim.y + h) * Lq + row;
    stat_m[r] = m;
    stat_inv[r] = inv;
  }
}

// ---- the bf16 inference forward on the tensor cores (see the top) --------
template <int DH, bool VEC16>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Lkv, Strides sq,
                    Strides sk, Strides sv, Strides so, float scale) {
  constexpr int P = DH + 8;        // row pitch of the shared tiles
  constexpr int KS = DH / 16;      // k-steps of Q K^T
  constexpr int NS = kTile / 8;    // key n-tiles of S
  constexpr int NO = DH / 8;       // feature n-tiles of O
  // two stages of [K tile | V tile]; stage 1 first holds the q tile
  __shared__ __align__(16) __nv_bfloat16 kv[2][2 * kTile * P];
  static_assert(2 * kTile >= kRows, "the q tile must fit in one stage");
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma group and lane in it
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  copy_rows<DH, VEC16, kMmaThreads>(
      kv[1], q + b * sq.b + h * sq.h + row0 * sq.r, sq.r, kRows);
  cp_async_commit();
  copy_rows<DH, VEC16, kMmaThreads>(kv[0], kb, sk.r, kTile);
  copy_rows<DH, VEC16, kMmaThreads>(kv[0] + kTile * P, vb, sv.r, kTile);
  cp_async_commit();
  cp_async_wait<1>();   // the q tile is in
  __syncthreads();
  uint32_t qa[KS][4];    // this warp's 16 q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* p = kv[1] + (warp * 16 + g) * P + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * P);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * P + 8);
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  // this lane's rows g (c = 0, 1) and g + 8 (c = 2, 3), key columns
  // n*8 + 2t + {0, 1}
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // one barrier per tile: after it, tile j is in from every thread's
  // copies, and every warp is done with tile j - 1 (and, at j = 0, with
  // the q tile), so tile j + 1 may load into that buffer while tile j is
  // computed
  const int tiles = Lkv / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();   // tile j is in, from this thread's copies
    __syncthreads();
    if (j + 1 < tiles) {
      __nv_bfloat16* nxt = kv[(j + 1) & 1];
      const int64_t k0 = (int64_t)(j + 1) * kTile;
      copy_rows<DH, VEC16, kMmaThreads>(nxt, kb + k0 * sk.r, sk.r, kTile);
      copy_rows<DH, VEC16, kMmaThreads>(nxt + kTile * P, vb + k0 * sv.r,
                                        sv.r, kTile);
      cp_async_commit();
    }
    const __nv_bfloat16* kt = kv[j & 1];
    const __nv_bfloat16* vt = kt + kTile * P;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kp = kt + (n * 8 + g) * P + kk * 16 + 2 * t;
        mma_bf16(s[n], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }
    // the scaled fp32 scores (rounded once, not contracted into the
    // exponent's argument), the running max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = __fmul_rn(s[n][c], scale);
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);   // finite: no masking
      alpha[rr] = __expf(m[rr] - m_new);          // 0 on the first tile
      m[rr] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = __expf(s[n][c] - m[c >> 1]);
        sum[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      l[rr] = l[rr] * alpha[rr] + sum[rr];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
    // O += bf16(P) V: the accumulators of key n-tiles 2kk, 2kk + 1 are the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (kk * 16 + (lane & 15)) * P + n * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[n], pa, bf[0], bf[1]);
        mma_bf16(acc[n + 1], pa, bf[2], bf[3]);
      }
    }
  }
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    __nv_bfloat16* orow = ob + (row0 + warp * 16 + g + 8 * hr) * so.r;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float lo = acc[n][2 * hr] / l[hr];
      const float hi = acc[n][2 * hr + 1] / l[hr];
      __nv_bfloat16* dst = orow + n * 8 + 2 * t;
      if (VEC16) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
      } else {
        dst[0] = __float2bfloat16(lo);
        dst[1] = __float2bfloat16(hi);
      }
    }
  }
}

// Backward launch 1 in bf16 on the CUDA cores: dq (B, Lq, H*DH)
// contiguous, and D_i = dO_i . o_i into delta, for this thread's q row
// against every key. dout (input type) and o (fp32) are contiguous
// (B, Lq, H*DH).
template <typename T, int DH, bool MASKED>
__global__ void __launch_bounds__(kRows)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ o,
                   const T* __restrict__ dout, const float* __restrict__ rq,
                   const float* __restrict__ rkv,
                   const float* __restrict__ stat_m,
                   const float* __restrict__ stat_inv,
                   float* __restrict__ delta, T* __restrict__ dq, int Lq,
                   int Lkv, Strides sq, Strides sk, Strides sv, float scale) {
  __shared__ __align__(16) float ks[kTile * DH];
  __shared__ __align__(16) float vs[kTile * DH];
  __shared__ float ids[MASKED ? kTile : 1];
  const int b = blockIdx.z, h = blockIdx.y;
  const int64_t D = (int64_t)gridDim.y * DH;
  const int64_t row = (int64_t)blockIdx.x * kRows + threadIdx.x;
  const int64_t srow = ((int64_t)b * gridDim.y + h) * Lq + row;
  const int64_t prow = ((int64_t)b * Lq + row) * D + h * DH;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float rid = MASKED ? rq[(int64_t)b * Lq + row] : 0.f;

  float qr[DH], dor[DH], acc[DH];
  load_row<T, DH>(q + b * sq.b + h * sq.h + row * sq.r, qr);
  load_row<T, DH>(dout + prow, dor);
  load_row<float, DH>(o + prow, acc);   // o, to form D_i
  float di = 0.f;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    di = fmaf(dor[i], acc[i], di);
    acc[i] = 0.f;
  }
  delta[srow] = di;
  const float m = stat_m[srow], inv = stat_inv[srow];

  for (int k0 = 0; k0 < Lkv; k0 += kTile) {
    __syncthreads();
    stage_tile<T, DH>(kb, sk.r, k0, ks);
    stage_tile<T, DH>(vb, sv.r, k0, vs);
    if (MASKED && threadIdx.x < kTile)
      ids[threadIdx.x] = rkv[(int64_t)b * Lkv + k0 + threadIdx.x];
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float s = score<MASKED>(dot_sm<DH>(qr, ks + j * DH), scale, rid,
                                    MASKED ? ids[j] : 0.f);
      const float p = __expf(s - m) * inv;
      const float dp = dot_sm<DH>(dor, vs + j * DH);
      axpy_sm<DH>(acc, p * (dp - di), ks + j * DH);
    }
  }
  T* dst = dq + prow;
#pragma unroll
  for (int i = 0; i < DH; ++i) store_f(dst + i, acc[i] * scale);
}

// Backward launch 2 in bf16: this thread's key row against q rows
// [split * q_chunk, min(Lq, (split + 1) * q_chunk)), block x = split *
// (Lkv / kRows) + key block. Writes unscaled fp32 partial dk and dv at
// ((split * B + b) * Lkv + key) * H*DH + h*DH.
template <typename T, int DH, bool MASKED>
__global__ void __launch_bounds__(kRows)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ rq,
                    const float* __restrict__ rkv,
                    const float* __restrict__ stat_m,
                    const float* __restrict__ stat_inv,
                    const float* __restrict__ delta,
                    float* __restrict__ dk_part, float* __restrict__ dv_part,
                    int Lq, int Lkv, int q_chunk, Strides sq, Strides sk,
                    Strides sv, float scale) {
  __shared__ __align__(16) float qs[kTile * DH];
  __shared__ __align__(16) float dos[kTile * DH];
  __shared__ float s_m[kTile], s_inv[kTile], s_di[kTile];
  __shared__ float ids[MASKED ? kTile : 1];
  const int b = blockIdx.z, h = blockIdx.y;
  const int H = gridDim.y;
  const int64_t D = (int64_t)H * DH;
  const int nkb = Lkv / kRows;
  const int split = blockIdx.x / nkb;
  const int64_t key = (int64_t)(blockIdx.x % nkb) * kRows + threadIdx.x;
  const int q0 = split * q_chunk;
  const int q1 = min(Lq, q0 + q_chunk);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + (int64_t)b * Lq * D + h * DH;
  const int64_t sbase = ((int64_t)b * H + h) * Lq;
  const float rid = MASKED ? rkv[(int64_t)b * Lkv + key] : 0.f;

  float kr[DH], vr[DH], dk[DH], dv[DH];
  load_row<T, DH>(k + b * sk.b + h * sk.h + key * sk.r, kr);
  load_row<T, DH>(v + b * sv.b + h * sv.h + key * sv.r, vr);
#pragma unroll
  for (int i = 0; i < DH; ++i) dk[i] = dv[i] = 0.f;

  for (int t0 = q0; t0 < q1; t0 += kTile) {
    __syncthreads();
    stage_tile<T, DH>(qb, sq.r, t0, qs);
    stage_tile<T, DH>(dob, D, t0, dos);
    if (threadIdx.x < kTile) {
      const int64_t r = sbase + t0 + threadIdx.x;
      s_m[threadIdx.x] = stat_m[r];
      s_inv[threadIdx.x] = stat_inv[r];
      s_di[threadIdx.x] = delta[r];
      if (MASKED) ids[threadIdx.x] = rq[(int64_t)b * Lq + t0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      // kr . q_i multiplies the same pairs in the same order as the
      // forward's q_i . k_j: the same score
      const float s = score<MASKED>(dot_sm<DH>(kr, qs + i * DH), scale,
                                    MASKED ? ids[i] : 0.f, rid);
      const float p = __expf(s - s_m[i]) * s_inv[i];
      const float dp = dot_sm<DH>(vr, dos + i * DH);
      axpy_sm<DH>(dv, p, dos + i * DH);
      axpy_sm<DH>(dk, p * (dp - s_di[i]), qs + i * DH);
    }
  }
  const int64_t out = ((int64_t)(split * gridDim.z + b) * Lkv + key) * D +
                      h * DH;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    dk_part[out + i] = dk[i];
    dv_part[out + i] = dv[i];
  }
}

// Backward launch 3 (both types): dk = scale * sum over splits, dv = sum
// over splits, in split order, each of n = B * Lkv * H*DH elements.
template <typename T>
__global__ void attn_bwd_reduce_kernel(const float* __restrict__ dk_part,
                                       const float* __restrict__ dv_part,
                                       T* __restrict__ dk, T* __restrict__ dv,
                                       int64_t n, int splits, float scale) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += dk_part[s * n + i];
      c += dv_part[s * n + i];
    }
    store_f(dk + i, a * scale);
    store_f(dv + i, c);
  }
}

// the bf16 MASKED or STATS forward on the CUDA cores
template <int DH, bool MASKED, bool STATS>
void launch_fwd_bf16(const FwdArgs& a, dim3 grid, cudaStream_t s) {
  using T = __nv_bfloat16;
  using TO = typename std::conditional<STATS, float, T>::type;
  attn_fwd_kernel<T, TO, DH, MASKED, STATS><<<grid, kRows, 0, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (TO*)a.o, a.rq, a.rkv,
      a.stat_m, a.stat_inv, a.Lq, a.Lkv, a.sq, a.sk, a.sv, a.so, a.scale);
}

template <bool MASKED, bool STATS>
void launch_fwd_bf16_dh(const FwdArgs& a, int dh, dim3 grid,
                        cudaStream_t s) {
  if (dh == 32)
    launch_fwd_bf16<32, MASKED, STATS>(a, grid, s);
  else
    launch_fwd_bf16<64, MASKED, STATS>(a, grid, s);
}

bool shape_ok(int B, int H, int Lq, int Lkv, int dh) {
  return B >= 1 && H >= 1 && B <= 65535 && H <= 65535 && Lq >= kRows &&
         Lq % kRows == 0 && Lkv >= kTile && Lkv % kTile == 0 &&
         (dh == 32 || dh == 64);
}

// 16-byte copies need a 16-byte aligned base and strides of 8 elements
bool aligned16(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.r % 8 == 0;
}

template <int DH, bool VEC16>
void launch_mma(const FwdArgs& a, dim3 grid, cudaStream_t s) {
  using T = __nv_bfloat16;
  attn_fwd_mma_kernel<DH, VEC16><<<grid, kMmaThreads, 0, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.Lkv, a.sq,
      a.sk, a.sv, a.so, a.scale);
}

// the bf16 unmasked inference forward: the tensor-core kernel, its 16-byte
// copy variant wherever every operand allows it
void launch_mma_dh(const FwdArgs& a, int dh, dim3 grid, cudaStream_t s) {
  const bool v16 = aligned16(a.q, a.sq) && aligned16(a.k, a.sk) &&
                   aligned16(a.v, a.sv) && aligned16(a.o, a.so);
  if (dh == 32)
    v16 ? launch_mma<32, true>(a, grid, s) : launch_mma<32, false>(a, grid, s);
  else
    v16 ? launch_mma<64, true>(a, grid, s) : launch_mma<64, false>(a, grid, s);
}

// rq == rkv == nullptr: unmasked; both set: region-masked. stats: the
// training forward (o fp32, stat_m and stat_inv written). Every fp32 call
// runs the split-TF32 kernel; in bf16 an unmasked call without stats runs
// the tensor-core kernel, every other call the CUDA-core one.
int launch(const FwdArgs& a, int B, int H, int dh, bool stats, int bf16,
           void* stream) {
  if (!shape_ok(B, H, a.Lq, a.Lkv, dh) || (a.rq == nullptr) != (a.rkv ==
      nullptr) || (stats && (a.stat_m == nullptr || a.stat_inv == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.Lq / kRows, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16)
    return launch_fwd_tf32x3(a, dh, stats, grid, s);
  if (a.rq && stats)
    launch_fwd_bf16_dh<true, true>(a, dh, grid, s);
  else if (a.rq)
    launch_fwd_bf16_dh<true, false>(a, dh, grid, s);
  else if (stats)
    launch_fwd_bf16_dh<false, true>(a, dh, grid, s);
  else
    launch_mma_dh(a, dh, grid, s);
  return (int)cudaGetLastError();
}

// launch 3: the partials summed, dk scaled, both in the input type
template <typename T>
int launch_reduce(const BwdArgs& a, int dh, int splits, cudaStream_t s) {
  const int64_t n = (int64_t)a.B * a.Lkv * a.H * dh;
  const int64_t blocks = (n + 255) / 256;
  attn_bwd_reduce_kernel<T><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                              s>>>(a.dk_part, a.dv_part, (T*)a.dk, (T*)a.dv,
                                   n, splits, a.scale);
  return (int)cudaGetLastError();
}

int q_splits(const BwdArgs& a) {
  return (a.Lq + a.q_chunk - 1) / a.q_chunk;
}

// the bf16 backward on the CUDA cores
template <int DH, bool MASKED>
int launch_bwd_bf16(const BwdArgs& a, cudaStream_t s) {
  using T = __nv_bfloat16;
  attn_bwd_dq_kernel<T, DH, MASKED><<<dim3(a.Lq / kRows, a.H, a.B), kRows, 0,
                                      s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.o, (const T*)a.dout,
      a.rq, a.rkv, a.stat_m, a.stat_inv, a.delta, (T*)a.dq, a.Lq, a.Lkv,
      a.sq, a.sk, a.sv, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int splits = q_splits(a);
  attn_bwd_dkv_kernel<T, DH, MASKED><<<dim3(splits * (a.Lkv / kRows), a.H,
                                            a.B), kRows, 0, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.rq,
      a.rkv, a.stat_m, a.stat_inv, a.delta, a.dk_part, a.dv_part, a.Lq,
      a.Lkv, a.q_chunk, a.sq, a.sk, a.sv, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<T>(a, DH, splits, s);
}

int launch_bwd(const BwdArgs& a, int dh, bool bf16, cudaStream_t s) {
  if (bf16) {
    if (a.rq)
      return dh == 32 ? launch_bwd_bf16<32, true>(a, s)
                      : launch_bwd_bf16<64, true>(a, s);
    return dh == 32 ? launch_bwd_bf16<32, false>(a, s)
                    : launch_bwd_bf16<64, false>(a, s);
  }
  const int splits = q_splits(a);
  const int err = launch_bwd_tf32x3(a, dh, splits, s);
  return err ? err : launch_reduce<float>(a, dh, splits, s);
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
  return launch({q, k, v, o, nullptr, nullptr, nullptr, nullptr, Lq, Lkv,
                 {Lq * q_row, hs, q_row}, {Lkv * k_row, hs, k_row},
                 {Lkv * v_row, hs, v_row}, {Lq * o_row, hs, o_row}, scale},
                B, H, dh, false, bf16, stream);
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
  return launch({q, k, v, o, rq, rkv, nullptr, nullptr, Lq, Lkv,
                 {Lq * q_row, hs, q_row}, {Lkv * k_row, hs, k_row},
                 {Lkv * v_row, hs, v_row}, {Lq * o_row, hs, o_row}, scale},
                B, H, dh, false, bf16, stream);
}

// The training forward of both packed routes: as attn_unmasked_packed_fwd
// (rq == rkv == nullptr) or attn_region_packed_fwd, but o32 is a
// contiguous fp32 (B, Lq, H*dh), and stat_m, stat_inv (B, H, Lq) fp32
// receive each row's max and 1/denominator.
extern "C" int attn_packed_fwd_stats(const void* q, const void* k,
                                     const void* v, const float* rq,
                                     const float* rkv, float* o32,
                                     float* stat_m, float* stat_inv, int B,
                                     int H, int Lq, int Lkv, int dh,
                                     int64_t q_row, int64_t k_row,
                                     int64_t v_row, float scale, int bf16,
                                     void* stream) {
  const int64_t hs = dh, d = (int64_t)H * dh;
  return launch({q, k, v, o32, rq, rkv, stat_m, stat_inv, Lq, Lkv,
                 {Lq * q_row, hs, q_row}, {Lkv * k_row, hs, k_row},
                 {Lkv * v_row, hs, v_row}, {Lq * d, hs, d}, scale},
                B, H, dh, true, bf16, stream);
}

// The backward of both packed routes (three launches, see the top of this
// file). q, k, v, rq, rkv as the forward took them; o32, stat_m, stat_inv
// from attn_packed_fwd_stats; dout (B, Lq, H*dh) contiguous in the input
// type. Scratch: delta (B, H, Lq) fp32, dk_part and dv_part
// (ceil(Lq / q_chunk), B, Lkv, H*dh) fp32. Results dq (B, Lq, H*dh), dk and
// dv (B, Lkv, H*dh), contiguous, in the input type. Lkv must be a multiple
// of 128 and q_chunk a positive multiple of 64.
extern "C" int attn_packed_bwd(const void* q, const void* k, const void* v,
                               const float* rq, const float* rkv,
                               const float* o32, const void* dout,
                               const float* stat_m, const float* stat_inv,
                               float* delta, float* dk_part, float* dv_part,
                               void* dq, void* dk, void* dv, int B, int H,
                               int Lq, int Lkv, int dh, int64_t q_row,
                               int64_t k_row, int64_t v_row, int q_chunk,
                               float scale, int bf16, void* stream) {
  if (!shape_ok(B, H, Lq, Lkv, dh) || Lkv % kRows || q_chunk < kTile ||
      q_chunk % kTile || (rq == nullptr) != (rkv == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t hs = dh;
  const BwdArgs a{q, k, v, dout, o32, rq, rkv, stat_m, stat_inv, delta,
                  dk_part, dv_part, dq, dk, dv, B, H, Lq, Lkv, q_chunk,
                  {Lq * q_row, hs, q_row}, {Lkv * k_row, hs, k_row},
                  {Lkv * v_row, hs, v_row}, scale};
  return launch_bwd(a, dh, bf16 != 0, (cudaStream_t)stream);
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
  return launch({q, k, v, o, nullptr, nullptr, nullptr, nullptr, Lq, Lkv,
                 {q_b, q_h, q_r}, {k_b, k_h, k_r}, {v_b, v_h, v_r},
                 {o_b, o_h, o_r}, scale},
                B, H, dh, false, bf16, stream);
}
