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
// then this file's reduce; their helpers are csrc/tf32x3.cuh. (Three
// sources, so that nvcc compiles them in parallel.) One TF32 product
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
// The rounding points are the bf16 kernels' (below): s = fp32 product
// times scale with __fmul_rn, MASKED adds -1e10 with __fadd_rn, the running
// max from -inf, p = exp(s - m) in fp32, l in fp32, o = acc * (1/l); STATS
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
// bf16: every call runs on the tensor cores, mma.sync m16n8k16 (bf16 in,
// fp32 accumulators): the forward `attn_fwd_mma_kernel` (unmasked
// inference: B7, B3 and B10 on the packed layout, B5 on the head-major one;
// MASKED: B6; STATS: the training forward of B6 and B7), the backward
// `attn_bwd_dq_mma_kernel` then `attn_bwd_dkv_mma_kernel` and the reduce.
// They compute the JAX kernels' function at their rounding points
// (region_attention.py `_fwd_body` :63-81 and `_bwd_body` :96-142,
// flash_attention.py `_packed_kernel` :136-160 and the online
// `_flash_kernel` :46-79):
//   s = fp32(q k^T) * scale (+ -1e10 where the ids are equal, MASKED),
//   m the running row max from -inf, p = exp(s - m) in fp32 (unmasked:
//   2^(q.k * scale*log2(e) - m*log2(e)) as one FMA, as the dropout kernels
//   form it; the argument differs from JAX's by an ulp, and the forward
//   runs ~10 % faster at det level 0, scripts/time_seg_attention.py),
//   l = sum p in fp32, the rescale exp(m_old - m_new),
//   o = (bf16(p) v, accumulated in fp32) / l, rounded to bf16.
// What bounds them: 4*B*H*Lq*Lkv*dh flops forward, 10*B*H*Lq*Lkv*dh
// backward, on the tensor cores (989 TFLOP/s bf16), against 2 bytes per
// q, k, v, o (and dO, dq, dk, dv) element, 4 per o32 element and row
// statistic; at TBSRN's shape (B 256, L 1024, 4 heads of 32) the forward's
// 137 GFLOP take 0.139 ms, the bytes 0.03 ms; at the det recipe's level 0
// (B 2, Lq 65,536, Lkv 1024, dh 32) 17.2 and 42.9 GFLOP take 0.017 and
// 0.043 ms, the training forward's bytes (q, o and o32) 0.006 ms. At
// dh = 32 each score costs 4*dh = 128 tensor-core flops forward but also a
// scale, a max, a subtraction, an exponential and an add on the CUDA cores
// (and in the backward a second exponential and the dS arithmetic), so
// the per-score work, not the products, is what the design keeps lean.
// The design is FlashAttention-2 on mma.sync, B1's attention loop
// (csrc/fused_enhancer.cu `attention_mma`) on strided operands:
//   * one block of 8 warps per 128 rows (q rows; keys in the dK/dV pass);
//     each warp owns 16 rows and keeps their A fragments in registers for
//     the whole loop (Q; Q and dO; K and V);
//   * the other side's 64-row tiles stay bf16 in shared memory, rows
//     padded by 8 elements so the fragment loads are free of bank
//     conflicts, double-buffered with 16-byte cp.async copies: tile j + 1
//     loads while tile j is computed. MASKED stages the tile's 64 key ids
//     beside K/V (the dK/dV pass: the q rows' ids, m, 1/l and D beside
//     Q/dO); each lane keeps its two rows' ids in registers. Where a base
//     pointer or a stride rules out 16-byte copies (a column slice at an
//     odd element offset), a compile-time variant copies 2 bytes at a time;
//   * S = Q K^T as dh/16 k-steps x 8 n-tiles per warp, the B fragments as
//     32-bit loads from the row-major (key, d) tile; the online softmax on
//     the accumulator fragments (a row's values sit in the 4 lanes of a
//     quad and reduce with two xor shuffles);
//   * P rounded to bf16 and repacked in registers: the m16n8 C layout of
//     two adjacent key n-tiles is the m16n8k16 A layout, so P never goes
//     through shared memory; V's B fragments come through ldmatrix.trans.
// STATS: the backward forms D_i = dO_i . o_i, which JAX takes from the
// fp32 probabilities (rowsum(dP probs)), while the bf16 o is (bf16(p) v)/l
// as JAX rounds it. So p is split into a bf16 pair hi = bf16(p), lo =
// bf16(p - hi), one extra product: o = acc_hi / l in bf16 and
// o32 = (acc_hi + acc_lo) / l in fp32, beside m and 1/l per (image, head,
// row). D from bf16(p) alone took dq to 0.009 norm-relative from JAX's
// bf16 kernels on the "rising" case of the CPU model (tests/
// test_torch_seg_bf16_rounding.py), against a bar of 0.01.
// The backward: S and dP = dO V^T, one bf16 product each (exact in fp32);
// p = exp(s - m) * (1/l) from the saved statistics with the forward's
// rounding; dS = p (dP - D). P and dS are rounded to bf16 for dV and dK;
// for dQ dS is a bf16 pair hi + lo: a row of dS sums to 0, and one
// rounding lets K's mean over the keys into dQ (0.011 on "rising" in the
// model). The CPU model (tests/torch_attention_cases.py
// `bf16_attention_model`) stays within a quarter of the 0.01 bar in dk
// and dv and 3e-4 in dq. The dQ pass (launch 1) also writes D for the dK/dV
// pass (launch 2); both are held to 128 registers at dh = 32 (2 blocks an
// SM). No wgmma and no TMA: mma.sync at 8 warps per block is the proven
// base (B1, B4); warp-group products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "unmasked_attention.cuh"

namespace {

using namespace seg_attn;

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

using bf16 = __nv_bfloat16;

// 2^x on the SFU (what __expf runs after its own multiply by log2(e))
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- bf16 on the tensor cores (see the top) -------------------------------
// The forward. MASKED: pairs whose ids a.rq (B, Lq), a.rkv (B, Lkv) are
// equal get -1e10 added to their score. STATS: the training forward, o
// (bf16, a.o at a.so) and o32 (fp32, contiguous (B, Lq, H*DH)), and the row
// max and 1/denominator at a.stat_m, a.stat_inv ((b * H + h) * Lq + row).
template <int DH, bool VEC16, bool MASKED, bool STATS>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_mma_kernel(const FwdArgs a) {
  constexpr int P = DH + 8;        // row pitch of the shared tiles
  constexpr int KS = DH / 16;      // k-steps of Q K^T
  constexpr int NS = kTile / 8;    // key n-tiles of S
  constexpr int NO = DH / 8;       // feature n-tiles of O
  // two stages of [K tile | V tile]; stage 1 first holds the q tile
  __shared__ __align__(16) bf16 kv[2][2 * kTile * P];
  __shared__ __align__(16) float ids[2][MASKED ? kTile : 2];
  static_assert(2 * kTile >= kRows, "the q tile must fit in one stage");
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma group and lane in it
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const bf16* kb = (const bf16*)a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = (const bf16*)a.v + b * a.sv.b + h * a.sv.h;
  const float* ib = MASKED ? a.rkv + (int64_t)b * a.Lkv : nullptr;
  // key tile j into stage j & 1: K and V rows, and (MASKED) their ids
  auto issue = [&](int j) {
    bf16* st = kv[j & 1];
    const int64_t k0 = (int64_t)j * kTile;
    copy_rows<DH, VEC16, kMmaThreads>(st, kb + k0 * a.sk.r, a.sk.r, kTile);
    copy_rows<DH, VEC16, kMmaThreads>(st + kTile * P, vb + k0 * a.sv.r,
                                      a.sv.r, kTile);
    if (MASKED && threadIdx.x < kTile)
      cp_async4(&ids[j & 1][threadIdx.x], ib + k0 + threadIdx.x);
    cp_async_commit();
  };

  copy_rows<DH, VEC16, kMmaThreads>(
      kv[1], (const bf16*)a.q + b * a.sq.b + h * a.sq.h + row0 * a.sq.r,
      a.sq.r, kRows);
  cp_async_commit();
  issue(0);
  cp_async_wait<1>();   // the q tile is in
  __syncthreads();
  uint32_t qa[KS][4];    // this warp's 16 q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* p = kv[1] + (warp * 16 + g) * P + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * P);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * P + 8);
  }
  // this lane's rows g (c = 0, 1) and g + 8 (c = 2, 3), key columns
  // n*8 + 2t + {0, 1}
  const int64_t rowg = row0 + warp * 16 + g;
  float rid[2] = {0.f, 0.f};
  if (MASKED) {
    rid[0] = a.rq[(int64_t)b * a.Lq + rowg];
    rid[1] = a.rq[(int64_t)b * a.Lq + rowg + 8];
  }
  // bf16(p) V and, STATS, (p - bf16(p)) V (unused otherwise: no registers)
  float acc[NO][4], lo[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = lo[n][c] = 0.f;
  // the running max: of the scaled, masked scores (MASKED); of the raw
  // products otherwise (scale > 0), whose p = exp(s * scale - m * scale)
  // is one FMA in base 2 with scale * log2(e) folded in
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * 1.4426950408889634f;

  // one barrier per tile: after it, tile j is in from every thread's
  // copies, and every warp is done with tile j - 1 (and, at j = 0, with
  // the q tile), so tile j + 1 may load into that buffer while tile j is
  // computed
  const int tiles = a.Lkv / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();   // tile j is in, from this thread's copies
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    const bf16* kt = kv[j & 1];
    const bf16* vt = kt + kTile * P;

    float s[NS][4];
    mma_abt(s, qa, kt, g, t);
    // MASKED: the scaled fp32 scores, rounded once, the suppression added
    // and rounded again, as the JAX kernel rounds them (a row whose keys
    // are all suppressed is uniform); the running max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float2 kid = make_float2(0.f, 0.f);
      if (MASKED)
        kid = *reinterpret_cast<const float2*>(&ids[j & 1][n * 8 + 2 * t]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (MASKED) {
          s[n][c] = __fmul_rn(s[n][c], a.scale);
          s[n][c] = __fadd_rn(
              s[n][c], rid[c >> 1] == ((c & 1) ? kid.y : kid.x) ? kNeg : 0.f);
        }
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f}, mb[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      // finite: a suppressed score is -1e10, not -inf
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = MASKED ? __expf(m[rr] - m_new)   // 0 on the first tile
                         : ex2f((m[rr] - m_new) * sl2);
      m[rr] = m_new;
      mb[rr] = m_new * sl2;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = MASKED ? __expf(s[n][c] - m[c >> 1])
                         : ex2f(fmaf(s[n][c], sl2, -mb[c >> 1]));
        sum[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      l[rr] = l[rr] * alpha[rr] + quad_sum(sum[rr]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[n][c] *= alpha[c >> 1];
        if (STATS) lo[n][c] *= alpha[c >> 1];
      }
    // O += bf16(P) V (STATS: and (P - bf16(P)) V into lo): the accumulators
    // of key n-tiles 2kk, 2kk + 1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* si = s[2 * kk + (i >> 1)] + 2 * (i & 1);
        pa[i] = pack_bf16(si[0], si[1]);
        if (STATS) {
          const float2 hi = unpack_bf16(pa[i]);
          pl[i] = pack_bf16(si[0] - hi.x, si[1] - hi.y);
        }
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (kk * 16 + (lane & 15)) * P + n * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[n], pa, bf[0], bf[1]);
        mma_bf16(acc[n + 1], pa, bf[2], bf[3]);
        if (STATS) {
          mma_bf16(lo[n], pl, bf[0], bf[1]);
          mma_bf16(lo[n + 1], pl, bf[2], bf[3]);
        }
      }
    }
  }
  bf16* ob = (bf16*)a.o + b * a.so.b + h * a.so.h;
  const int64_t D = (int64_t)gridDim.y * DH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t row = rowg + 8 * hr;
    bf16* orow = ob + row * a.so.r;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      st_pair<VEC16>(orow + n * 8 + 2 * t, acc[n][2 * hr] / l[hr],
                     acc[n][2 * hr + 1] / l[hr]);
    if (STATS) {
      float* o32 = a.o32 + ((int64_t)b * a.Lq + row) * D + h * DH + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(o32 + n * 8) =
            make_float2((acc[n][2 * hr] + lo[n][2 * hr]) / l[hr],
                        (acc[n][2 * hr + 1] + lo[n][2 * hr + 1]) / l[hr]);
      if (t == 0) {
        const int64_t r = ((int64_t)b * gridDim.y + h) * a.Lq + row;
        // in the scores' units, as the backward forms them
        a.stat_m[r] = MASKED ? m[hr] : __fmul_rn(m[hr], a.scale);
        a.stat_inv[r] = 1.f / l[hr];
      }
    }
  }
}

// the probability of one score element x (fp32 product) with the
// forward's rounding, from the row's saved max m and 1/denominator inv
template <bool MASKED>
__device__ __forceinline__ float prob(float x, float scale, float rid,
                                      float kid, float m, float inv) {
  x = __fmul_rn(x, scale);
  if (MASKED) x = __fadd_rn(x, rid == kid ? kNeg : 0.f);
  return __expf(x - m) * inv;
}

// Backward launch 1: dq (B, Lq, H*DH) contiguous, and D_i = dO_i . o32_i
// into delta, for this warp's 16 q rows against every key. dout (bf16) and
// o32 (fp32) are contiguous (B, Lq, H*DH). dQ = scale (dS_hi + dS_lo) K.
template <int DH, bool VEC16, bool MASKED>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? 2 : 1)
attn_bwd_dq_mma_kernel(const BwdArgs a) {
  constexpr int P = DH + 8, T = kTile * P;
  constexpr int KS = DH / 16, NS = kTile / 8, NO = DH / 8;
  __shared__ __align__(16) bf16 kv[2][2 * T];   // [K | V] x 2
  __shared__ __align__(16) float ids[2][MASKED ? kTile : 2];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t D = (int64_t)a.H * DH;
  const int64_t row0 = (int64_t)blockIdx.x * kRows + warp * 16;
  const int64_t srow0 = ((int64_t)b * a.H + h) * a.Lq + row0;
  const int64_t prow0 = ((int64_t)b * a.Lq + row0) * D + h * DH;
  const bf16* kb = (const bf16*)a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = (const bf16*)a.v + b * a.sv.b + h * a.sv.h;
  const float* ib = MASKED ? a.rkv + (int64_t)b * a.Lkv : nullptr;

  auto issue = [&](int j) {
    bf16* st = kv[j & 1];
    const int64_t k0 = (int64_t)j * kTile;
    copy_rows<DH, VEC16, kMmaThreads>(st, kb + k0 * a.sk.r, a.sk.r, kTile);
    copy_rows<DH, VEC16, kMmaThreads>(st + T, vb + k0 * a.sv.r, a.sv.r,
                                      kTile);
    if (MASKED && threadIdx.x < kTile)
      cp_async4(&ids[j & 1][threadIdx.x], ib + k0 + threadIdx.x);
    cp_async_commit();
  };
  issue(0);
  uint32_t qa[KS][4], da[KS][4];
  load_a<VEC16>(qa, (const bf16*)a.q + b * a.sq.b + h * a.sq.h +
                        row0 * a.sq.r, a.sq.r, g, t);
  load_a<VEC16>(da, (const bf16*)a.dout + prow0, D, g, t);
  // D_i over this lane's features of dO's fragments, then the quad: the
  // fragment (kk, i) holds row g + 8 (i & 1), features kk*16 + 2t +
  // 8 (i >> 1) + {0, 1}
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack_bf16(da[kk][i]);
      const float2 y = *reinterpret_cast<const float2*>(
          a.o + prow0 + (g + 8 * (i & 1)) * D + kk * 16 + 2 * t +
          8 * (i >> 1));
      di[i & 1] = fmaf(x.x, y.x, di[i & 1]);
      di[i & 1] = fmaf(x.y, y.y, di[i & 1]);
    }
  float m[2], inv[2], rid[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    di[rr] = quad_sum(di[rr]);
    m[rr] = a.stat_m[srow0 + g + 8 * rr];
    inv[rr] = a.stat_inv[srow0 + g + 8 * rr];
    if (MASKED) rid[rr] = a.rq[(int64_t)b * a.Lq + row0 + g + 8 * rr];
    if (t == 0) a.delta[srow0 + g + 8 * rr] = di[rr];
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;

  const int tiles = a.Lkv / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    const bf16* kt = kv[j & 1];
    float s[NS][4], dp[NS][4];
    mma_abt(s, qa, kt, g, t);
    mma_abt(dp, da, kt + T, g, t);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float2 kid = make_float2(0.f, 0.f);
      if (MASKED)
        kid = *reinterpret_cast<const float2*>(&ids[j & 1][n * 8 + 2 * t]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = prob<MASKED>(s[n][c], a.scale, rid[c >> 1],
                                     (c & 1) ? kid.y : kid.x, m[c >> 1],
                                     inv[c >> 1]);
        s[n][c] = p * (dp[n][c] - di[c >> 1]);   // dS
      }
    }
    mma_xb<true>(acc, s, kt, lane);   // dQ += (dS_hi + dS_lo) K
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    bf16* dst = (bf16*)a.dq + prow0 + (g + 8 * hr) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      st_pair<true>(dst + n * 8, acc[n][2 * hr] * a.scale,
                    acc[n][2 * hr + 1] * a.scale);
  }
}

// Backward launch 2: this warp's 16 keys against the q rows
// [split * q_chunk, min(Lq, (split + 1) * q_chunk)), block x = split *
// (Lkv / kRows) + key block. dV += bf16(P)^T dO, dK += bf16(dS)^T Q;
// writes unscaled fp32 partial dk and dv at ((split * B + b) * Lkv + key)
// * H*DH + h*DH.
template <int DH, bool VEC16, bool MASKED>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? 2 : 1)
attn_bwd_dkv_mma_kernel(const BwdArgs a) {
  constexpr int P = DH + 8, T = kTile * P;
  constexpr int KS = DH / 16, NS = kTile / 8, NO = DH / 8;
  constexpr int NROW = MASKED ? 4 : 3;   // m, 1/l, D (and ids) per q row
  __shared__ __align__(16) bf16 sm[2][2 * T];   // [Q | dO] x 2
  __shared__ __align__(16) float rows_f[2][4][kTile];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t D = (int64_t)a.H * DH;
  const int nkb = a.Lkv / kRows;
  const int split = blockIdx.x / nkb;
  const int64_t key0 = (int64_t)(blockIdx.x % nkb) * kRows + warp * 16;
  const int q0 = split * a.q_chunk;
  const int q1 = min(a.Lq, q0 + a.q_chunk);
  const bf16* qb = (const bf16*)a.q + b * a.sq.b + h * a.sq.h;
  const bf16* dob = (const bf16*)a.dout + (int64_t)b * a.Lq * D + h * DH;
  const int64_t sbase = ((int64_t)b * a.H + h) * a.Lq;

  // q tile j into stage j & 1: Q and dO rows, and the rows' m, 1/l, D and
  // ids
  auto issue = [&](int j) {
    bf16* st = sm[j & 1];
    const int64_t r0 = q0 + (int64_t)j * kTile;
    copy_rows<DH, VEC16, kMmaThreads>(st, qb + r0 * a.sq.r, a.sq.r, kTile);
    copy_rows<DH, VEC16, kMmaThreads>(st + T, dob + r0 * D, D, kTile);
    if (threadIdx.x < NROW * kTile) {
      const int w = threadIdx.x / kTile, r = threadIdx.x % kTile;
      const float* src = w == 0 ? a.stat_m + sbase
                         : w == 1 ? a.stat_inv + sbase
                         : w == 2 ? a.delta + sbase
                                  : a.rq + (int64_t)b * a.Lq;
      cp_async4(&rows_f[j & 1][w][r], src + r0 + r);
    }
    cp_async_commit();
  };
  issue(0);
  uint32_t ka[KS][4], va[KS][4];   // this warp's keys
  load_a<VEC16>(ka, (const bf16*)a.k + b * a.sk.b + h * a.sk.h +
                        key0 * a.sk.r, a.sk.r, g, t);
  load_a<VEC16>(va, (const bf16*)a.v + b * a.sv.b + h * a.sv.h +
                        key0 * a.sv.r, a.sv.r, g, t);
  float rkey[2] = {0.f, 0.f};
  if (MASKED) {
    rkey[0] = a.rkv[(int64_t)b * a.Lkv + key0 + g];
    rkey[1] = a.rkv[(int64_t)b * a.Lkv + key0 + g + 8];
  }
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  const int tiles = (q1 - q0) / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    const bf16* qt = sm[j & 1];
    const bf16* dot = qt + T;
    const float* sm_m = rows_f[j & 1][0];
    const float* sm_inv = rows_f[j & 1][1];
    const float* sm_d = rows_f[j & 1][2];
    const float* sm_id = rows_f[j & 1][3];
    // S^T = K Q^T and dP^T = V dO^T: element (n, c) is key g + 8 (c >> 1)
    // and q row n*8 + 2t + (c & 1) of the tile
    float s[NS][4], dp[NS][4];
    mma_abt(s, ka, qt, g, t);
    mma_abt(dp, va, dot, g, t);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = n * 8 + 2 * t + (c & 1);
        const float p = prob<MASKED>(s[n][c], a.scale,
                                     MASKED ? sm_id[qc] : 0.f, rkey[c >> 1],
                                     sm_m[qc], sm_inv[qc]);
        s[n][c] = p;
        dp[n][c] = p * (dp[n][c] - sm_d[qc]);   // dS^T
      }
    mma_xb(dv, s, dot, lane);   // dV += bf16(P)^T dO
    mma_xb(dk, dp, qt, lane);   // dK += bf16(dS)^T Q
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t out =
        ((int64_t)(split * gridDim.z + b) * a.Lkv + key0 + g + 8 * hr) * D +
        h * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(a.dk_part + out + n * 8) =
          make_float2(dk[n][2 * hr], dk[n][2 * hr + 1]);
      *reinterpret_cast<float2*>(a.dv_part + out + n * 8) =
          make_float2(dv[n][2 * hr], dv[n][2 * hr + 1]);
    }
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

template <int DH, bool VEC16, bool MASKED, bool STATS>
void launch_mma(const FwdArgs& a, dim3 grid, cudaStream_t s) {
  attn_fwd_mma_kernel<DH, VEC16, MASKED, STATS>
      <<<grid, kMmaThreads, 0, s>>>(a);
}

// the bf16 forward: the 16-byte copy variant wherever every operand allows
// it
template <bool MASKED, bool STATS>
void launch_mma_dh(const FwdArgs& a, int dh, dim3 grid, cudaStream_t s) {
  const bool v16 = aligned16(a.q, a.sq) && aligned16(a.k, a.sk) &&
                   aligned16(a.v, a.sv) && aligned16(a.o, a.so);
  if (dh == 32)
    v16 ? launch_mma<32, true, MASKED, STATS>(a, grid, s)
        : launch_mma<32, false, MASKED, STATS>(a, grid, s);
  else
    v16 ? launch_mma<64, true, MASKED, STATS>(a, grid, s)
        : launch_mma<64, false, MASKED, STATS>(a, grid, s);
}

// rq == rkv == nullptr: unmasked; both set: region-masked. stats: the
// training forward (o32, stat_m and stat_inv written; in bf16 also o).
// Every fp32 call runs the split-TF32 kernel, every bf16 call the
// tensor-core one.
int launch(const FwdArgs& a, int B, int H, int dh, bool stats, int bf16,
           void* stream) {
  if (!shape_ok(B, H, a.Lq, a.Lkv, dh) || (a.rq == nullptr) != (a.rkv ==
      nullptr) || (stats && (a.stat_m == nullptr || a.stat_inv == nullptr))
      || a.o == nullptr || (stats && bf16 && a.o32 == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.Lq / kRows, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16)
    return launch_fwd_tf32x3(a, dh, stats, grid, s);
  if (a.rq && stats)
    launch_mma_dh<true, true>(a, dh, grid, s);
  else if (a.rq)
    launch_mma_dh<true, false>(a, dh, grid, s);
  else if (stats)
    launch_mma_dh<false, true>(a, dh, grid, s);
  else
    launch_mma_dh<false, false>(a, dh, grid, s);
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

// the bf16 backward on the tensor cores: launches 1 and 2, then the reduce
template <int DH, bool VEC16, bool MASKED>
int launch_bwd_bf16(const BwdArgs& a, cudaStream_t s) {
  attn_bwd_dq_mma_kernel<DH, VEC16, MASKED>
      <<<dim3(a.Lq / kRows, a.H, a.B), kMmaThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int splits = q_splits(a);
  attn_bwd_dkv_mma_kernel<DH, VEC16, MASKED>
      <<<dim3(splits * (a.Lkv / kRows), a.H, a.B), kMmaThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<bf16>(a, DH, splits, s);
}

template <int DH, bool MASKED>
int launch_bwd_bf16_v(const BwdArgs& a, cudaStream_t s) {
  const int64_t D = (int64_t)a.H * DH;
  const bool v16 = aligned16(a.q, a.sq) && aligned16(a.k, a.sk) &&
                   aligned16(a.v, a.sv) &&
                   aligned16(a.dout, {(int64_t)a.Lq * D, DH, D});
  return v16 ? launch_bwd_bf16<DH, true, MASKED>(a, s)
             : launch_bwd_bf16<DH, false, MASKED>(a, s);
}

int launch_bwd(const BwdArgs& a, int dh, bool bf16, cudaStream_t s) {
  if (bf16) {
    if (a.rq)
      return dh == 32 ? launch_bwd_bf16_v<32, true>(a, s)
                      : launch_bwd_bf16_v<64, true>(a, s);
    return dh == 32 ? launch_bwd_bf16_v<32, false>(a, s)
                    : launch_bwd_bf16_v<64, false>(a, s);
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
// receive each row's max and 1/denominator. In bf16 o (B, Lq, H*dh)
// contiguous receives the output, o32 the product of the fp32
// probabilities; in fp32 o is nullptr and o32 is the output.
extern "C" int attn_packed_fwd_stats(const void* q, const void* k,
                                     const void* v, const float* rq,
                                     const float* rkv, void* o, float* o32,
                                     float* stat_m, float* stat_inv, int B,
                                     int H, int Lq, int Lkv, int dh,
                                     int64_t q_row, int64_t k_row,
                                     int64_t v_row, float scale, int bf16,
                                     void* stream) {
  const int64_t hs = dh, d = (int64_t)H * dh;
  FwdArgs a{q, k, v, bf16 ? o : o32, rq, rkv, stat_m, stat_inv, Lq, Lkv,
            {Lq * q_row, hs, q_row}, {Lkv * k_row, hs, k_row},
            {Lkv * v_row, hs, v_row}, {Lq * d, hs, d}, scale};
  a.o32 = o32;
  return launch(a, B, H, dh, true, bf16, stream);
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
