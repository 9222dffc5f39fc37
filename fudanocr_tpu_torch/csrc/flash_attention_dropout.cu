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
// fp32 (every fp32 call; csrc/flash_attention_dropout_tf32x3.cu, whose top
// has the design): the tensor cores in split TF32 (3xTF32), each fp32
// operand as TF32 hi + lo and three mma.sync m16n8k8 products, at the fp32
// bar, with the bf16 kernels' blocks, tiles and keep bits (below):
// `attn_dropout_fwd_tf32x3_kernel` writes o and the per-row log-sum-exp
// lse = max + log(denom) (B*H*L fp32, the only residual beside qkv, o and
// the seed); the backward is `attn_dropout_bwd_dq_tf32x3_kernel` (dQ, and
// D_i = dO_i . o_i, which equals rowsum(keep dP' P) under dropout) then
// `attn_dropout_bwd_dkv_tf32x3_kernel` (dK and dV). Every dqkv element is
// written once: deterministic. No CUDA-core fp32 kernel is built.
//
// bf16 (the tensor-core kernels `attn_dropout_fwd_mma_kernel`,
// `attn_dropout_dsum_mma_kernel` and `attn_dropout_bwd_mma_kernel`; every
// bf16 call runs them): mma.sync m16n8k16 (bf16 operands, fp32
// accumulators), the loop of
// csrc/unmasked_attention.cu `attn_fwd_mma_kernel`. A block is 8
// warps; each warp owns 16 q rows (forward, dQ role) or 16 keys (dK/dV
// role) and keeps their A fragments in registers for the whole loop. The
// other side streams through shared memory in 64-row bf16 tiles (rows
// padded by 8 elements against bank conflicts), double-buffered with
// 16-byte cp.async copies; where a pointer or stride rules those out, a
// compile-time variant of the same kernels copies 2 bytes at a time.
//   * Forward: S = Q K^T; the online max and the denominator over all keys
//     in fp32, p = exp(s * scale - max) as 2^(one FMA) with scale * log2(e)
//     folded in (JAX rounds s * scale first: the arguments differ by an
//     ulp); the keep bit of each accumulator element from its (q, key)
//     counter; the dropped p zeroed, the kept p rounded to bf16 (JAX's
//     `p.astype(vh.dtype)`) and repacked in registers as the A fragment of
//     O += P V; o * inv_keep / l rounded to bf16, lse in fp32.
//   * Backward: two launches. First attn_dropout_dsum_mma_kernel forms
//     each q row's D' = rowsum(keep P dP) in fp32, as JAX's backward does
//     (S and dP on the tensor cores, the forward's loop), and lse in base
//     2. Taking D from the bf16 output instead (dO . o, as the fp32
//     kernels do) left up to 1.7e-2 norm-relative in dQ from JAX's kernels
//     at a peaked softmax, where dS = P (dP - D) cancels (CPU model,
//     tests/test_torch_dropout_rounding.py). Then the split, all five
//     products on the tensor cores. S and dP = dO V^T are exact in their
//     bf16 inputs. JAX's bf16 backward multiplies keep * P (for dV) and dS
//     (for dQ and dK) in fp32; here keep * P and dS are rounded to bf16
//     for dV and dK, and dS is split into a bf16 pair hi + lo for dQ (a
//     row of dS sums to 0; one rounding lets K's mean over the keys into
//     dQ: 1.1e-2 at keys with a common offset). The model of these
//     rounding points (tests/torch_attention_cases.py
//     `dropout_rounding_model`) is ~2.7e-3 norm-relative from JAX's
//     kernels on standard-normal and peaked inputs, against the bf16 bar
//     of 1e-2. inv_keep and the scale are applied once to the fp32 sums.
//     The split is one launch with no atomics: blocks [0, L/128) own 128 q
//     rows each and build dQ, blocks [L/128, L/64) own 128 keys each and
//     build dK and dV; every dqkv element is written once.
//     The dK/dV role stages Q and dO and copies the rows' D' and lse with
//     them (one barrier per tile).
//   * The hash: each (q, key) keep bit is computed once per role, in
//     registers (~10 integer operations), and serves both P and dP; the
//     backward computes it in three roles (D', dQ, dK/dV).
//   * Occupancy: the backward is held to 128 registers a thread
//     (__launch_bounds__(256, 2); ptxas spills 28-104 bytes), so two
//     blocks share an SM; at its own 184 registers one block an SM ran it
//     ~10 % slower on an H100.
//
// What bounds it on this card: per (image, head) the forward does
// 4*L^2*dh flops (2 products) and the backward 10*L^2*dh (5 products, the
// JAX CostEstimate), against O(L*dh) bytes. In bf16 at dh = 32 those flops
// are few beside the per-score work on the CUDA cores: the hash (~10
// integer operations per score and role), the exponential and the softmax
// arithmetic. That integer work, not the products, sets the floor of the
// bf16 kernels. In fp32 each product costs three TF32 products at 495
// TFLOP/s, and they set the floor (0.208 ms forward, 0.521 backward at
// (64, 1024, 384), against the hash's 0.161 a pass). Nothing of size L x L
// touches memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "flash_attention_dropout.cuh"

namespace {

using namespace dropout_attn;

constexpr int kRows = 128;   // q rows (fwd, dQ role) or keys (dKV role) per block
constexpr int kTile = 64;    // keys per K/V tile, q rows per Q/dO tile

// keep decision of (q, k) (flash_attention.py:275 `_keep_mask`)
__device__ __forceinline__ bool keep_qk(uint32_t seed_bh, uint32_t q,
                                        uint32_t k, uint32_t L,
                                        uint32_t thresh) {
  return fmix32((q * L + k) ^ seed_bh) < thresh;
}

// ---- bf16 on the tensor cores (see the top) -------------------------------
constexpr int kMmaWarps = kRows / 16;        // 16 rows (q or keys) per warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kDH = 32;                      // the head width of B4 / B11
constexpr int kPitch = kDH + 8;              // row pitch of the shared tiles
constexpr int kTileElems = kTile * kPitch;   // one (kTile, kDH) shared tile
static_assert(kMmaThreads == 4 * kTile, "four lanes per q row for D");

using bf16 = __nv_bfloat16;

// 2^x on the SFU (what __expf runs after its own multiply by log2(e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Forward: one block of 8 warps per (128-row q tile, head, image); each warp
// owns 16 q rows. VEC16: every operand allows 16-byte copies.
template <bool VEC16>
__global__ void __launch_bounds__(kMmaThreads)
attn_dropout_fwd_mma_kernel(Operand q_op, Operand k_op, Operand v_op,
                            const int64_t* __restrict__ seed,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int L, int H, float scale, float inv_keep,
                            uint32_t thresh, uint32_t b0) {
  constexpr int NS = kTile / 8, NO = kDH / 8;
  __shared__ __align__(16) bf16 kv[2][2 * kTileElems];   // [K | V] x 2
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma group and lane in it
  const int row0 = blockIdx.x * kRows + warp * 16;
  const bf16* kb = (const bf16*)k_op.p + (int64_t)b * L * k_op.row + h * kDH;
  const bf16* vb = (const bf16*)v_op.p + (int64_t)b * L * v_op.row + h * kDH;
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b0 + b, h, H);

  copy_rows<kDH, VEC16, kMmaThreads>(kv[0], kb, k_op.row, kTile);
  copy_rows<kDH, VEC16, kMmaThreads>(kv[0] + kTileElems, vb, v_op.row,
                                     kTile);
  cp_async_commit();
  uint32_t qa[kDH / 16][4];   // this warp's q rows, for the whole key loop
  load_a<VEC16>(qa, (const bf16*)q_op.p + ((int64_t)b * L + row0) * q_op.row
                        + h * kDH, q_op.row, g, t);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
  // this lane's rows g (c = 0, 1) and g + 8 (c = 2, 3), keys n*8 + 2t +
  // (c & 1); their hash counters q * L + key at key 2t of tile 0
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t ctr0 = (uint32_t)(row0 + g) * (uint32_t)L + 2 * t;
  const uint32_t ctr8 = ctr0 + 8u * (uint32_t)L;
  // p = exp(s * scale - max) as one FMA in base 2
  const float sl2 = scale * kLog2e;

  // one barrier per tile: after it tile j is in from every thread's copies
  // and every warp is done with tile j - 1, whose buffer tile j + 1 fills
  const int tiles = L / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) {
      bf16* nxt = kv[(j + 1) & 1];
      const int64_t k0 = (int64_t)(j + 1) * kTile;
      copy_rows<kDH, VEC16, kMmaThreads>(nxt, kb + k0 * k_op.row, k_op.row,
                                         kTile);
      copy_rows<kDH, VEC16, kMmaThreads>(nxt + kTileElems,
                                         vb + k0 * v_op.row, v_op.row, kTile);
      cp_async_commit();
    }
    const bf16* kt = kv[j & 1];
    float s[NS][4];
    mma_abt(s, qa, kt, g, t);
    // the running max over the quad, of the unscaled scores (scale > 0)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
    float alpha[2], sum[2] = {0.f, 0.f}, mb[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = ex2((m[rr] - m_new) * sl2);   // 0 on the first tile
      m[rr] = m_new;
      mb[rr] = m_new * sl2;
    }
    // the denominator over every key; the value product over kept keys
    const uint32_t k0 = (uint32_t)j * kTile;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ex2(fmaf(s[n][c], sl2, -mb[c >> 1]));
        sum[c >> 1] += p;
        const uint32_t ctr = (c < 2 ? ctr0 : ctr8) + k0 + n * 8 + (c & 1);
        s[n][c] = fmix32(ctr ^ sbh) < thresh ? p : 0.f;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + quad_sum(sum[rr]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
    mma_xb(acc, s, kt + kTileElems, lane);
  }
  const int D = H * kDH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    const float f = inv_keep / l[hr];
    bf16* orow = out + ((int64_t)b * L + row) * D + h * kDH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      st_pair<VEC16>(orow + n * 8 + 2 * t, acc[n][2 * hr] * f,
                     acc[n][2 * hr + 1] * f);
    if (t == 0)
      lse[((int64_t)b * H + h) * L + row] = m[hr] * scale + logf(l[hr]);
  }
}

// The backward's row terms, before it: per q row D' = rowsum(keep P dP),
// in fp32 from fp32 P and dP as JAX's backward forms it, and lse in base 2,
// into dsum and lse2 (B, H, L). D' is not taken as dO . o from the bf16
// output: at a peaked softmax dS = P (keep dP - D') cancels, and o's
// rounding would decide dS. The forward's loop, one block of 8 warps per
// (128-row q tile, head, image), with dP = dO V^T in place of the value
// product.
template <bool VEC16>
__global__ void __launch_bounds__(kMmaThreads)
attn_dropout_dsum_mma_kernel(Operand q_op, Operand k_op, Operand v_op,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const int64_t* __restrict__ seed,
                             float* __restrict__ dsum,
                             float* __restrict__ lse2, int L, int H,
                             float scale, uint32_t thresh, uint32_t b0) {
  constexpr int NS = kTile / 8;
  __shared__ __align__(16) bf16 kv[2][2 * kTileElems];   // [K | V] x 2
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows + warp * 16;
  const int D = H * kDH;
  const int64_t bh = (int64_t)b * H + h;
  const bf16* kb = (const bf16*)k_op.p + (int64_t)b * L * k_op.row + h * kDH;
  const bf16* vb = (const bf16*)v_op.p + (int64_t)b * L * v_op.row + h * kDH;
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b0 + b, h, H);

  copy_rows<kDH, VEC16, kMmaThreads>(kv[0], kb, k_op.row, kTile);
  copy_rows<kDH, VEC16, kMmaThreads>(kv[0] + kTileElems, vb, v_op.row,
                                     kTile);
  cp_async_commit();
  uint32_t qa[kDH / 16][4], da[kDH / 16][4];
  load_a<VEC16>(qa, (const bf16*)q_op.p + ((int64_t)b * L + row0) * q_op.row
                        + h * kDH, q_op.row, g, t);
  load_a<VEC16>(da, dout + ((int64_t)b * L + row0) * D + h * kDH, D, g, t);
  const float sl2 = scale * kLog2e;
  const float lr[2] = {lse[bh * L + row0 + g] * kLog2e,
                       lse[bh * L + row0 + g + 8] * kLog2e};
  float ds[2] = {0.f, 0.f};
  const uint32_t ctr0 = (uint32_t)(row0 + g) * (uint32_t)L + 2 * t;
  const uint32_t ctr8 = ctr0 + 8u * (uint32_t)L;
  const int tiles = L / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) {
      bf16* nxt = kv[(j + 1) & 1];
      const int64_t k0 = (int64_t)(j + 1) * kTile;
      copy_rows<kDH, VEC16, kMmaThreads>(nxt, kb + k0 * k_op.row, k_op.row,
                                         kTile);
      copy_rows<kDH, VEC16, kMmaThreads>(nxt + kTileElems,
                                         vb + k0 * v_op.row, v_op.row, kTile);
      cp_async_commit();
    }
    const bf16* kt = kv[j & 1];
    float sc[NS][4], dp[NS][4];
    mma_abt(sc, qa, kt, g, t);
    mma_abt(dp, da, kt + kTileElems, g, t);
    const uint32_t k0 = (uint32_t)j * kTile;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t ctr = (c < 2 ? ctr0 : ctr8) + k0 + n * 8 + (c & 1);
        if (fmix32(ctr ^ sbh) < thresh)
          ds[c >> 1] = fmaf(ex2(fmaf(sc[n][c], sl2, -lr[c >> 1])), dp[n][c],
                            ds[c >> 1]);
      }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float d = quad_sum(ds[hr]);
    if (t == 0) {
      dsum[bh * L + row0 + g + 8 * hr] = d;
      lse2[bh * L + row0 + g + 8 * hr] = lr[hr];
    }
  }
}

// Backward, FlashAttention-2's split: blocks
// [0, L/128) own 128 q rows each and build dQ, blocks [L/128, L/64) own 128
// keys each and build dK and dV; each warp owns 16 of the rows or keys.
// With P = exp(s - lse) and D' = rowsum(keep P dP) per q row (dsum, from
// attn_dropout_dsum_mma_kernel), the gradient of the dropped softmax is
//   dS = inv_keep * P * (keep * dP - D'),  dP = dO V^T,
// so dV = inv_keep * (keep P)^T dO, dQ = scale * inv_keep * dS' K and
// dK = scale * inv_keep * dS'^T Q with dS' = P * (keep * dP - D'); keep P
// and dS' are rounded to bf16 for dV and dK. For dQ dS' is split into a
// bf16 pair: a row of dS' sums to 0, and one rounding would let K's mean
// over the keys into dQ.
template <bool VEC16>
__global__ void __launch_bounds__(kMmaThreads, 2)
attn_dropout_bwd_mma_kernel(Operand q_op, Operand k_op, Operand v_op,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ dsum,
                            const float* __restrict__ lse2,
                            const int64_t* __restrict__ seed, Grad dq_g,
                            Grad dk_g, Grad dv_g, int L, int H, float scale,
                            float inv_keep, uint32_t thresh, uint32_t b0) {
  constexpr int NS = kTile / 8, NO = kDH / 8;
  // two stages of two tiles: [K | V] (dQ role), [Q | dO] (dK/dV)
  __shared__ __align__(16) bf16 sm[2][2 * kTileElems];
  // per stage, the dK/dV role's lse2 and D' of the tile's q rows
  __shared__ __align__(16) float rows_f[2][2][kTile];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = L / kRows, D = H * kDH, tiles = L / kTile;
  const bf16* qb = (const bf16*)q_op.p + (int64_t)b * L * q_op.row + h * kDH;
  const bf16* kb = (const bf16*)k_op.p + (int64_t)b * L * k_op.row + h * kDH;
  const bf16* vb = (const bf16*)v_op.p + (int64_t)b * L * v_op.row + h * kDH;
  const bf16* dob = dout + (int64_t)b * L * D + h * kDH;
  const float* dsum_bh = dsum + ((int64_t)b * H + h) * L;
  const float* lse2_bh = lse2 + ((int64_t)b * H + h) * L;
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b0 + b, h, H);
  const float dscale = scale * inv_keep;

  if ((int)blockIdx.x < nq) {
    // dQ role: this warp's 16 q rows against every key
    const int row0 = blockIdx.x * kRows + warp * 16;
    copy_rows<kDH, VEC16, kMmaThreads>(sm[0], kb, k_op.row, kTile);
    copy_rows<kDH, VEC16, kMmaThreads>(sm[0] + kTileElems, vb, v_op.row,
                                       kTile);
    cp_async_commit();
    uint32_t qa[kDH / 16][4], da[kDH / 16][4];
    load_a<VEC16>(qa, qb + (int64_t)row0 * q_op.row, q_op.row, g, t);
    load_a<VEC16>(da, dob + (int64_t)row0 * D, D, g, t);
    // P = exp(s * scale - lse) as one FMA in base 2
    const float sl2 = scale * kLog2e;
    const float lr[2] = {lse2_bh[row0 + g], lse2_bh[row0 + g + 8]};
    const float dsub[2] = {dsum_bh[row0 + g], dsum_bh[row0 + g + 8]};
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
        acc[n][3] = 0.f;
    const uint32_t ctr0 = (uint32_t)(row0 + g) * (uint32_t)L + 2 * t;
    const uint32_t ctr8 = ctr0 + 8u * (uint32_t)L;
    for (int j = 0; j < tiles; ++j) {
      cp_async_wait<0>();
      __syncthreads();
      if (j + 1 < tiles) {
        bf16* nxt = sm[(j + 1) & 1];
        const int64_t k0 = (int64_t)(j + 1) * kTile;
        copy_rows<kDH, VEC16, kMmaThreads>(nxt, kb + k0 * k_op.row, k_op.row,
                                           kTile);
        copy_rows<kDH, VEC16, kMmaThreads>(nxt + kTileElems,
                                           vb + k0 * v_op.row, v_op.row,
                                           kTile);
        cp_async_commit();
      }
      const bf16* kt = sm[j & 1];
      float s[NS][4], dp[NS][4];
      mma_abt(s, qa, kt, g, t);
      mma_abt(dp, da, kt + kTileElems, g, t);
      const uint32_t k0 = (uint32_t)j * kTile;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = ex2(fmaf(s[n][c], sl2, -lr[c >> 1]));
          const uint32_t ctr = (c < 2 ? ctr0 : ctr8) + k0 + n * 8 + (c & 1);
          const float dpk = fmix32(ctr ^ sbh) < thresh ? dp[n][c] : 0.f;
          s[n][c] = p * (dpk - dsub[c >> 1]);
        }
      mma_xb<true>(acc, s, kt, lane);   // dQ += (dS'hi + dS'lo) K
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      bf16* dst = (bf16*)dq_g.p +
                  ((int64_t)b * L + row0 + g + 8 * hr) * dq_g.row + h * kDH;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        st_pair<VEC16>(dst + n * 8 + 2 * t, acc[n][2 * hr] * dscale,
                       acc[n][2 * hr + 1] * dscale);
    }
  } else {
    // dK/dV role: this warp's 16 keys against every q row
    const int key0 = (blockIdx.x - nq) * kRows + warp * 16;
    // stage q tile j: Q and dO rows, and their lse2 and D'
    auto issue = [&](int j) {
      bf16* dst = sm[j & 1];
      const int64_t q0 = (int64_t)j * kTile;
      copy_rows<kDH, VEC16, kMmaThreads>(dst, qb + q0 * q_op.row, q_op.row,
                                         kTile);
      copy_rows<kDH, VEC16, kMmaThreads>(dst + kTileElems, dob + q0 * D, D,
                                         kTile);
      if (threadIdx.x < 2 * kTile) {
        const int r = threadIdx.x & (kTile - 1), w = threadIdx.x / kTile;
        cp_async4(&rows_f[j & 1][w][r], (w ? dsum_bh : lse2_bh) + q0 + r);
      }
      cp_async_commit();
    };
    issue(0);
    uint32_t ka[kDH / 16][4], va[kDH / 16][4];
    load_a<VEC16>(ka, kb + (int64_t)key0 * k_op.row, k_op.row, g, t);
    load_a<VEC16>(va, vb + (int64_t)key0 * v_op.row, v_op.row, g, t);
    float dk[NO][4], dv[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
    const float sl2 = scale * kLog2e;
    // accumulator element (n, c): key key0 + g + 8 (c >> 1), q row of the
    // tile n*8 + 2t + (c & 1); the hash counter q * L + key at tile 0, n 0
    const uint32_t ctr0 = (uint32_t)(2 * t) * (uint32_t)L + key0 + g;
    for (int j = 0; j < tiles; ++j) {
      cp_async_wait<0>();
      __syncthreads();
      if (j + 1 < tiles) issue(j + 1);
      const bf16* qt = sm[j & 1];
      const bf16* dot = qt + kTileElems;
      const float* slse = rows_f[j & 1][0];
      const float* sdi = rows_f[j & 1][1];
      float s[NS][4], dp[NS][4];
      mma_abt(s, ka, qt, g, t);    // S^T = K Q^T
      mma_abt(dp, va, dot, g, t);  // dP^T = V dO^T
      const uint32_t cj = ctr0 + (uint32_t)j * kTile * (uint32_t)L;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = n * 8 + 2 * t + (c & 1);
          const float p = ex2(fmaf(s[n][c], sl2, -slse[qc]));
          const uint32_t ctr =
              cj + (uint32_t)(n * 8 + (c & 1)) * (uint32_t)L + 8 * (c >> 1);
          const bool kept = fmix32(ctr ^ sbh) < thresh;
          s[n][c] = kept ? p : 0.f;
          dp[n][c] = p * ((kept ? dp[n][c] : 0.f) - sdi[qc]);
        }
      mma_xb(dv, s, dot, lane);   // dV += (keep P)^T dO
      mma_xb(dk, dp, qt, lane);   // dK += dS'^T Q
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t key = (int64_t)b * L + key0 + g + 8 * hr;
      bf16* dkd = (bf16*)dk_g.p + key * dk_g.row + h * kDH;
      bf16* dvd = (bf16*)dv_g.p + key * dv_g.row + h * kDH;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        st_pair<VEC16>(dkd + n * 8 + 2 * t, dk[n][2 * hr] * dscale,
                       dk[n][2 * hr + 1] * dscale);
        st_pair<VEC16>(dvd + n * 8 + 2 * t, dv[n][2 * hr] * inv_keep,
                       dv[n][2 * hr + 1] * inv_keep);
      }
    }
  }
}

__global__ void attn_dropout_keep_kernel(const int64_t* __restrict__ seed,
                                         uint8_t* __restrict__ mask, int B,
                                         int H, int L, uint32_t thresh,
                                         uint32_t b0) {
  const int64_t n = (int64_t)B * H * L * L;
  const uint32_t s0 = (uint32_t)seed[0];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bh = i / ((int64_t)L * L);
    const int64_t qk = i % ((int64_t)L * L);
    const uint32_t sbh = bh_seed(s0, b0 + (uint32_t)(bh / H),
                                 (uint32_t)(bh % H),
                                 (uint32_t)H);
    mask[i] = keep_qk(sbh, (uint32_t)(qk / L), (uint32_t)(qk % L),
                      (uint32_t)L, thresh);
  }
}

bool shape_ok(int B, int L, int H, int dh) {
  return B >= 1 && H >= 1 && dh == 32 && L >= kRows && L % kRows == 0 &&
         B <= 65535 && H <= 65535;
}

// 16-byte copies need a 16-byte aligned base and a row stride of 8 elements
bool aligned16(const void* p, int64_t row) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && row % 8 == 0;
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = success).
// q, k, v (B, L, H*dh) with row strides q_row, k_row, v_row (feature stride
// 1, an image's rows one after another): the fused layout (B4) passes the
// column slices of one (B, L, 3*H*dh) qkv, row stride 3*H*dh, the split
// layout (B11) three buffers. out (B, L, H*dh) and dout contiguous, lse
// (B, H, L) fp32; seed points at one int64 on the device holding the uint32
// seed; b0 is the global index of image 0 (a data-parallel rank's first
// row: the keep hash keys image b on b0 + b, 0 on one process); bf16
// selects the element type of q/k/v/out/dout and the gradients (fp32
// otherwise); dh must be 32 and L a multiple of 128.
extern "C" int attn_dropout_fwd(const void* q, const void* k, const void* v,
                                const void* seed, void* out, void* lse, int B,
                                int L, int H, int dh, int64_t q_row,
                                int64_t k_row, int64_t v_row, float scale,
                                float inv_keep, unsigned int thresh,
                                unsigned int b0, int bf16, void* stream) {
  if (!shape_ok(B, L, H, dh)) return (int)cudaErrorInvalidValue;
  const dim3 grid(L / kRows, H, B);
  const Operand qo{q, q_row}, ko{k, k_row}, vo{v, v_row};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const bool v16 = aligned16(q, q_row) && aligned16(k, k_row) &&
                     aligned16(v, v_row) && aligned16(out, H * dh);
    auto* kernel = v16 ? attn_dropout_fwd_mma_kernel<true>
                       : attn_dropout_fwd_mma_kernel<false>;
    kernel<<<grid, kMmaThreads, 0, s>>>(qo, ko, vo, (const int64_t*)seed,
                                        (__nv_bfloat16*)out, (float*)lse, L, H,
                                        scale, inv_keep, thresh, b0);
    return (int)cudaGetLastError();
  }
  return dropout_attn::launch_fwd_tf32x3(
      {qo, ko, vo, (const int64_t*)seed, B, L, H, scale, inv_keep, thresh,
       b0},
      (float*)out, (float*)lse, s);
}

// The gradients dq, dk, dv (B, L, H*dh) with their own row strides (the
// column slices of one dqkv for B4). work: 2*B*H*L fp32 of scratch for the
// row terms: in bf16 D' and lse in base 2, in fp32 D (the first half).
extern "C" int attn_dropout_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* seed, void* dq, void* dk,
    void* dv, void* work, int B, int L, int H, int dh, int64_t q_row,
    int64_t k_row, int64_t v_row, int64_t dq_row, int64_t dk_row,
    int64_t dv_row, float scale, float inv_keep, unsigned int thresh,
    unsigned int b0, int bf16, void* stream) {
  if (!shape_ok(B, L, H, dh)) return (int)cudaErrorInvalidValue;
  const dim3 grid(2 * (L / kRows), H, B);
  const Operand qo{q, q_row}, ko{k, k_row}, vo{v, v_row};
  const Grad dqg{dq, dq_row}, dkg{dk, dk_row}, dvg{dv, dv_row};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const int64_t D = (int64_t)H * dh;
    const bool v16 = aligned16(q, q_row) && aligned16(k, k_row) &&
                     aligned16(v, v_row) && aligned16(dout, D) &&
                     aligned16(dq, dq_row) && aligned16(dk, dk_row) &&
                     aligned16(dv, dv_row);
    float* dsum = (float*)work;
    float* lse2 = dsum + (int64_t)B * H * L;
    auto* rows = v16 ? attn_dropout_dsum_mma_kernel<true>
                     : attn_dropout_dsum_mma_kernel<false>;
    rows<<<dim3(L / kRows, H, B), kMmaThreads, 0, s>>>(
        qo, ko, vo, (const __nv_bfloat16*)dout, (const float*)lse,
        (const int64_t*)seed, dsum, lse2, L, H, scale, thresh, b0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    auto* kernel = v16 ? attn_dropout_bwd_mma_kernel<true>
                       : attn_dropout_bwd_mma_kernel<false>;
    kernel<<<grid, kMmaThreads, 0, s>>>(
        qo, ko, vo, (const __nv_bfloat16*)dout, dsum, lse2,
        (const int64_t*)seed, dqg, dkg, dvg, L, H, scale, inv_keep, thresh,
        b0);
    return (int)cudaGetLastError();
  }
  return dropout_attn::launch_bwd_tf32x3(
      {qo, ko, vo, (const int64_t*)seed, B, L, H, scale, inv_keep, thresh,
       b0},
      (const float*)out, (const float*)dout, (const float*)lse, (float*)work,
      dqg, dkg, dvg, s);
}

// The (B, H, L, L) uint8 keep mask of images b0 .. b0 + B - 1, from the
// same __device__ hash the two kernels use (tests compare it with the plain
// version bit for bit).
extern "C" int attn_dropout_keep(const void* seed, void* mask, int B, int H,
                                 int L, unsigned int thresh, unsigned int b0,
                                 void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  attn_dropout_keep_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)seed, (uint8_t*)mask, B, H, L, thresh, b0);
  return (int)cudaGetLastError();
}
