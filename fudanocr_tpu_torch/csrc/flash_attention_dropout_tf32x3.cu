// The fp32 hash-dropout attention on the tensor cores in split TF32
// (3xTF32), hand-written for Hopper (sm_90a): every fp32 call of the C
// entries `attn_dropout_fwd` and `attn_dropout_bwd` of
// csrc/flash_attention_dropout.cu, so B4 (`flash_mha_qkv_packed_dropout`,
// column slices of one (B, L, 3D) qkv) and B11 (`flash_mha_packed_dropout`,
// three buffers). It replaces, in fp32, the Pallas TPU kernels
// fudanocr_tpu/ops/flash_attention.py `_qkv_dropout_fwd` (:505) and
// `_qkv_dropout_bwd` (:528), and `_packed_dropout_fwd` (:373) and
// `_packed_dropout_bwd` (:401). The function and the keep hash: the top of
// csrc/flash_attention_dropout.cu.
//
// What bounds it: per (image, head) the forward does 4*L^2*dh flops (two
// products) and the backward 10*L^2*dh (five), each as three TF32 products
// at the tensor cores' 495 TFLOP/s; beside them ~10 integer operations of
// the keep hash per score and pass at 16.7 Tops/s; O(L*dh) bytes. At
// (64, 1024, 384) the forward's floor is 0.208 ms (products; the hash
// alone 0.161), the backward's 0.521 (the CUDA cores' fp32 floors 0.513
// and 1.282).
//
// The design is the split-TF32 loop of the fp32 segmentation attention
// (csrc/unmasked_attention_fwd_tf32x3.cu, _bwd_tf32x3.cu; why three TF32
// products meet the fp32 bar where one does not: the top of
// csrc/unmasked_attention.cu), with the bf16 dropout kernels' keep bit per
// accumulator element (csrc/flash_attention_dropout.cu): a lane's four
// elements of an m16n8 tile sit at (row g or g + 8, column 2t or 2t + 1)
// in m16n8k8 TF32 as in m16n8k16 bf16, so its hash counter q * L + key is
// the same.
//   * One block of 8 warps per 128 rows (q rows, or keys in the dK/dV
//     launch); each warp owns 16 of them and holds their A operands split
//     into TF32 hi + lo for the whole loop (Q; Q and dO; K and V). The
//     other side streams through shared memory in 64-row fp32 tiles,
//     double-buffered with 16-byte cp.async copies (4-byte ones where a
//     base or a row stride rules those out: the same kernels, a run-time
//     flag) and split into hi + lo once per block, in place.
//   * Forward: s = fp32(Q K^T) * scale, the online max, p = exp(s - max);
//     the denominator adds every p, the dropped p is zeroed before it is
//     split for P V. Each tile's P V starts from zero and is added to the
//     rescaled running sum on the CUDA cores (the tensor cores round each
//     mma's sum toward zero; a sum carried through every key tile would
//     drift). o = acc * (inv_keep / l) and lse = max + log(l), fp32.
//   * Backward, FlashAttention-2's split with no atomics, two launches:
//     the dQ launch (q rows against every key) also writes each row's
//     D = dO . o from the fp32 output; the dK/dV launch (keys against every
//     q row) stages each Q/dO tile's lse and D with it. With P =
//     exp(s - lse) and dP = dO V^T: dS = P (keep * dP * inv_keep - D),
//     dQ = scale * dS K, dK = scale * dS^T Q, dV = inv_keep * (keep P)^T dO,
//     every dqkv element written once (deterministic). D is dO . o, not
//     JAX's rowsum(keep dP inv_keep P): in fp32 o carries no rounding that
//     matters (the CPU model, tests/torch_attention_cases.py
//     `dropout_tf32x3_model`, is within 1.9e-6 norm-relative of JAX's
//     kernels in dq, dk and dv with either form, also at a peaked softmax,
//     tests/test_torch_dropout_tf32x3_rounding.py), and it saves the bf16
//     backward's first pass over the keys.
//   * Both backward launches take a tile in chunks of 16 rows (S and dP in
//     registers) and keep their running sums (dQ; dK and dV) in shared
//     memory, each element owned by one lane, added to once per tile.
//   * Registers: every kernel is held to 128 a thread (2 blocks of 8
//     warps an SM; shared memory 74,240 B a block forward, 92,672 dQ,
//     112,640 dK/dV). ptxas (scripts/time_dropout_paths.py --ptxas, CUDA
//     on the H100 machine): forward 128 registers, 96 bytes of spill
//     stores and 100 of loads; dQ 128, 24 and 24; dK/dV 128, 224 and 424.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_dropout.cuh"
#include "tf32x3.cuh"

namespace {

using namespace dropout_attn;

constexpr int kDH = 32;              // the head width of B4 / B11
constexpr int kP = kDH + 4;          // row pitch of the shared tiles
constexpr int kT = kTile * kP;       // floats of one tile
constexpr int kKS = kDH / 8, kNS = kTile / 8, kNO = kDH / 8;
// floats of one stage: [K | K lo | V | V lo], or [Q | Q lo | dO | dO lo]
// and the Q/dO rows' lse and D (the segmentation kernels' stages)
constexpr int kKvStage = kv_stage_floats<kDH>();
constexpr int kQStage = q_stage_floats<kDH>();
constexpr int kFwdBytes = 2 * kKvStage * (int)sizeof(float);
constexpr int kDqBytes = (2 * kKvStage + kRows * kP) * (int)sizeof(float);
constexpr int kDkvBytes = (2 * kQStage + 2 * kRows * kP) * (int)sizeof(float);

// The base of image b, head h of an operand
__device__ __forceinline__ const float* head_base(const Operand& o, int b,
                                                  int h, int L) {
  return (const float*)o.p + (int64_t)b * L * o.row + h * kDH;
}

// This lane's elements of a warp's 16 x kDH running sum (`mine`, as
// add_to fills it) times f, into rows g, g + 8 of the gradient at dst (row
// g; row stride `row`)
__device__ __forceinline__ void store_rows(float* dst, int64_t row,
                                           const float* mine, float f,
                                           int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* d = dst + hr * 8 * row + 2 * t;
    const float* src = mine + hr * 8 * kP;
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      d[n * 8] = src[n * 8] * f;
      d[n * 8 + 1] = src[n * 8 + 1] * f;
    }
  }
}

// Forward: one block per (128-row q tile, head, image), each warp 16 q
// rows; o (B, L, H*kDH) and lse (B, H, L). vec16: k and v allow 16-byte
// copies.
__global__ void __launch_bounds__(kMmaThreads, kTf32Blocks32)
attn_dropout_fwd_tf32x3_kernel(Operand q_op, Operand k_op, Operand v_op,
                               const int64_t* __restrict__ seed,
                               float* __restrict__ out,
                               float* __restrict__ lse, int L, float scale,
                               float inv_keep, uint32_t thresh, uint32_t b0,
                               bool vec16) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma group and lane in it
  const int row0 = blockIdx.x * kRows + warp * 16;
  const float* kb = head_base(k_op, b, h, L);
  const float* vb = head_base(v_op, b, h, L);
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b0 + b, h, H);

  auto issue = [&](int j) {   // key tile j into stage j & 1
    float* st = smem + (j & 1) * kKvStage;
    const int64_t k0 = (int64_t)j * kTile;
    copy_tile_f32<kDH>(st, kb + k0 * k_op.row, k_op.row, vec16);
    copy_tile_f32<kDH>(st + 2 * kT, vb + k0 * v_op.row, v_op.row, vec16);
    cp_async_commit();
  };
  issue(0);
  AOperand<kKS> qa;   // this warp's q rows, split once
  load_a(qa, head_base(q_op, b, h, L) + (int64_t)row0 * q_op.row, q_op.row,
         g, t);
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
  // this lane's rows g (c = 0, 1) and g + 8 (c = 2, 3), keys n*8 + 2t +
  // (c & 1); their hash counters q * L + key at key 2t of tile 0
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t ctr0 = (uint32_t)(row0 + g) * (uint32_t)L + 2 * t;
  const uint32_t ctr8 = ctr0 + 8u * (uint32_t)L;

  // two barriers per tile: after the first, tile j is in from every
  // thread's copies and every warp is done with tile j - 1, whose stage
  // tile j + 1 fills; after the second, tile j is split
  const int tiles = L / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    float* st = smem + (j & 1) * kKvStage;
    split_tile<kDH>(st, st + kT);
    split_tile<kDH>(st + 2 * kT, st + 3 * kT);
    __syncthreads();

    float s[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
      float c[1][4];
      mma3_abt<kKS, 1, kP>(c, qa, st + n * 8 * kP, st + kT + n * 8 * kP, g,
                           t);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = __fmul_rn(c[0][i], scale);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m[rr], quad_max(mx[rr]));
      alpha[rr] = __expf(m[rr] - m_new);   // 0 on the first tile
      m[rr] = m_new;
    }
    // the denominator over every key; the value product over kept keys
    const uint32_t k0 = (uint32_t)j * kTile;
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = __expf(s[n][c] - m[c >> 1]);
        sum[c >> 1] += p;
        const uint32_t ctr = (c < 2 ? ctr0 : ctr8) + k0 + n * 8 + (c & 1);
        s[n][c] = fmix32(ctr ^ sbh) < thresh ? p : 0.f;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      l[rr] = l[rr] * alpha[rr] + quad_sum(sum[rr]);
    // this tile's P V from 0, then added to the rescaled running sum
    float part[kNO][4];
#pragma unroll
    for (int n = 0; n < kNO; ++n) part[n][0] = part[n][1] = part[n][2] =
        part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNS; ++kk)
      mma3_xb<kNO, kP>(part, s[kk], st + 2 * kT + kk * 8 * kP,
                       st + 3 * kT + kk * 8 * kP, g, t);
#pragma unroll
    for (int n = 0; n < kNO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n][c] = fmaf(acc[n][c], alpha[c >> 1], part[n][c]);
  }
  const int D = H * kDH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    const float f = inv_keep / l[hr];
    float* orow = out + ((int64_t)b * L + row) * D + h * kDH + 2 * t;
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      orow[n * 8] = acc[n][2 * hr] * f;
      orow[n * 8 + 1] = acc[n][2 * hr + 1] * f;
    }
    if (t == 0) lse[((int64_t)b * H + h) * L + row] = m[hr] + logf(l[hr]);
  }
}

// Backward launch 1: this warp's 16 q rows against every key: dq, and
// D = dO . o of each row into delta (B, H, L). vec16: k and v allow 16-byte
// copies.
__global__ void __launch_bounds__(kMmaThreads, kTf32Blocks32)
attn_dropout_bwd_dq_tf32x3_kernel(Operand q_op, Operand k_op, Operand v_op,
                                  const float* __restrict__ out,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const int64_t* __restrict__ seed,
                                  float* __restrict__ delta, Grad dq_g,
                                  int L, float scale, float inv_keep,
                                  uint32_t thresh, uint32_t b0, bool vec16) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t D = (int64_t)H * kDH;
  const int row0 = blockIdx.x * kRows + warp * 16;
  const int64_t srow0 = ((int64_t)b * H + h) * L + row0;
  const int64_t prow0 = ((int64_t)b * L + row0) * D + h * kDH;
  const float* kb = head_base(k_op, b, h, L);
  const float* vb = head_base(v_op, b, h, L);
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b0 + b, h, H);
  float* mine = smem + 2 * kKvStage + (warp * 16 + g) * kP + 2 * t;

  auto issue = [&](int j) {
    float* st = smem + (j & 1) * kKvStage;
    const int64_t k0 = (int64_t)j * kTile;
    copy_tile_f32<kDH>(st, kb + k0 * k_op.row, k_op.row, vec16);
    copy_tile_f32<kDH>(st + 2 * kT, vb + k0 * v_op.row, v_op.row, vec16);
    cp_async_commit();
  };
  issue(0);
  AOperand<kKS> qa, da;
  load_a(qa, head_base(q_op, b, h, L) + (int64_t)row0 * q_op.row, q_op.row,
         g, t);
  // dO's fragments, and D over this lane's features, then the quad
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t off =
          prow0 + (g + 8 * (i & 1)) * D + kk * 8 + t + 4 * (i >> 1);
      const float x = dout[off];
      di[i & 1] = fmaf(x, out[off], di[i & 1]);
      split_tf32(x, da.h[kk][i], da.l[kk][i]);
    }
  float lr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    di[rr] = quad_sum(di[rr]);
    lr[rr] = lse[srow0 + g + 8 * rr];
    if (t == 0) delta[srow0 + g + 8 * rr] = di[rr];
  }
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    mine[n * 8] = mine[n * 8 + 1] = 0.f;
    mine[8 * kP + n * 8] = mine[8 * kP + n * 8 + 1] = 0.f;
  }
  const uint32_t ctr0 = (uint32_t)(row0 + g) * (uint32_t)L + 2 * t;
  const uint32_t ctr8 = ctr0 + 8u * (uint32_t)L;

  const int tiles = L / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    float* st = smem + (j & 1) * kKvStage;
    split_tile<kDH>(st, st + kT);
    split_tile<kDH>(st + 2 * kT, st + 3 * kT);
    __syncthreads();
    float part[kNO][4];
#pragma unroll
    for (int n = 0; n < kNO; ++n) part[n][0] = part[n][1] = part[n][2] =
        part[n][3] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kNS; c0 += 2) {   // 16 keys at a time
      const int r0 = c0 * 8 * kP;
      float s[2][4], dp[2][4];
      mma3_abt<kKS, 2, kP>(s, qa, st + r0, st + kT + r0, g, t);
      mma3_abt<kKS, 2, kP>(dp, da, st + 2 * kT + r0, st + 3 * kT + r0, g, t);
      const uint32_t k0 = (uint32_t)(j * kTile + c0 * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = __expf(__fmul_rn(s[i][c], scale) - lr[c >> 1]);
          const uint32_t ctr = (c < 2 ? ctr0 : ctr8) + k0 + i * 8 + (c & 1);
          const float dpk =
              fmix32(ctr ^ sbh) < thresh ? dp[i][c] * inv_keep : 0.f;
          s[i][c] = p * (dpk - di[c >> 1]);   // dS
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)   // dQ += dS K
        mma3_xb<kNO, kP>(part, s[i], st + r0 + i * 8 * kP,
                         st + kT + r0 + i * 8 * kP, g, t);
    }
    add_to<kNO, kP>(mine, part);
  }
  store_rows((float*)dq_g.p + ((int64_t)b * L + row0 + g) * dq_g.row +
                 h * kDH,
             dq_g.row, mine, scale, t);
}

// Backward launch 2: this warp's 16 keys against every q row: dk and dv.
// vec16: q and dout allow 16-byte copies.
__global__ void __launch_bounds__(kMmaThreads, kTf32Blocks32)
attn_dropout_bwd_dkv_tf32x3_kernel(Operand q_op, Operand k_op, Operand v_op,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   const int64_t* __restrict__ seed,
                                   Grad dk_g, Grad dv_g, int L, float scale,
                                   float inv_keep, uint32_t thresh,
                                   uint32_t b0, bool vec16) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t D = (int64_t)H * kDH;
  const int key0 = blockIdx.x * kRows + warp * 16;
  const float* qb = head_base(q_op, b, h, L);
  const float* dob = dout + (int64_t)b * L * D + h * kDH;
  const int64_t sbase = ((int64_t)b * H + h) * L;
  const uint32_t sbh = bh_seed((uint32_t)seed[0], b0 + b, h, H);
  float* dk_mine = smem + 2 * kQStage + (warp * 16 + g) * kP + 2 * t;
  float* dv_mine = dk_mine + kRows * kP;

  // q tile j into stage j & 1: Q and dO rows, and the rows' lse and D
  auto issue = [&](int j) {
    float* st = smem + (j & 1) * kQStage;
    const int64_t r0 = (int64_t)j * kTile;
    copy_tile_f32<kDH>(st, qb + r0 * q_op.row, q_op.row, vec16);
    copy_tile_f32<kDH>(st + 2 * kT, dob + r0 * D, D, vec16);
    if (threadIdx.x < 2 * kTile) {
      const int w = threadIdx.x / kTile, r = threadIdx.x % kTile;
      cp_async4(st + 4 * kT + threadIdx.x, (w ? delta : lse) + sbase + r0 + r);
    }
    cp_async_commit();
  };
  issue(0);
  AOperand<kKS> ka, va;   // this warp's keys
  load_a(ka, head_base(k_op, b, h, L) + (int64_t)key0 * k_op.row, k_op.row,
         g, t);
  load_a(va, head_base(v_op, b, h, L) + (int64_t)key0 * v_op.row, v_op.row,
         g, t);
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    dk_mine[n * 8] = dk_mine[n * 8 + 1] = 0.f;
    dk_mine[8 * kP + n * 8] = dk_mine[8 * kP + n * 8 + 1] = 0.f;
    dv_mine[n * 8] = dv_mine[n * 8 + 1] = 0.f;
    dv_mine[8 * kP + n * 8] = dv_mine[8 * kP + n * 8 + 1] = 0.f;
  }
  // element (i, c) of a chunk: key key0 + g + 8 (c >> 1), q row of the
  // tile (c0 + i) * 8 + 2t + (c & 1); the hash counter q * L + key at q
  // row 2t, key key0 + g
  const uint32_t ctr0 = (uint32_t)(2 * t) * (uint32_t)L + key0 + g;

  const int tiles = L / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    float* st = smem + (j & 1) * kQStage;
    split_tile<kDH>(st, st + kT);
    split_tile<kDH>(st + 2 * kT, st + 3 * kT);
    __syncthreads();
    const float* sm_lse = st + 4 * kT;
    const float* sm_d = sm_lse + kTile;
    float kp[kNO][4], vp[kNO][4];
#pragma unroll
    for (int n = 0; n < kNO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) kp[n][c] = vp[n][c] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kNS; c0 += 2) {   // 16 q rows at a time
      const int r0 = c0 * 8 * kP;
      // S^T = K Q^T and dP^T = V dO^T
      float s[2][4], dp[2][4];
      mma3_abt<kKS, 2, kP>(s, ka, st + r0, st + kT + r0, g, t);
      mma3_abt<kKS, 2, kP>(dp, va, st + 2 * kT + r0, st + 3 * kT + r0, g, t);
      const uint32_t cj = ctr0 + (uint32_t)(j * kTile + c0 * 8) * (uint32_t)L;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = (c0 + i) * 8 + 2 * t + (c & 1);
          const float p = __expf(__fmul_rn(s[i][c], scale) - sm_lse[qc]);
          const uint32_t ctr =
              cj + (uint32_t)(i * 8 + (c & 1)) * (uint32_t)L + 8 * (c >> 1);
          const bool kept = fmix32(ctr ^ sbh) < thresh;
          s[i][c] = kept ? p : 0.f;
          dp[i][c] = p * ((kept ? dp[i][c] * inv_keep : 0.f) - sm_d[qc]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ri = r0 + i * 8 * kP;
        mma3_xb<kNO, kP>(vp, s[i], st + 2 * kT + ri, st + 3 * kT + ri, g, t);
        mma3_xb<kNO, kP>(kp, dp[i], st + ri, st + kT + ri, g, t);
      }
    }
    add_to<kNO, kP>(dk_mine, kp);
    add_to<kNO, kP>(dv_mine, vp);
  }
  const int64_t key = (int64_t)b * L + key0 + g;
  store_rows((float*)dk_g.p + key * dk_g.row + h * kDH, dk_g.row,
             dk_mine, scale, t);
  store_rows((float*)dv_g.p + key * dv_g.row + h * kDH, dv_g.row,
             dv_mine, inv_keep, t);
}

// 16-byte copies of an operand's rows (batch stride L * row)
bool vec16_f32(const void* p, int64_t row) {
  return aligned16_f32(p, {row, kDH, row});
}

}  // namespace

int dropout_attn::launch_fwd_tf32x3(const Args& a, float* out, float* lse,
                                    cudaStream_t s) {
  const cudaError_t err =
      allow_smem(attn_dropout_fwd_tf32x3_kernel, kFwdBytes);
  if (err != cudaSuccess) return (int)err;
  attn_dropout_fwd_tf32x3_kernel<<<dim3(a.L / kRows, a.H, a.B), kMmaThreads,
                                   kFwdBytes, s>>>(
      a.q, a.k, a.v, a.seed, out, lse, a.L, a.scale, a.inv_keep, a.thresh,
      a.b0,
      vec16_f32(a.k.p, a.k.row) && vec16_f32(a.v.p, a.v.row));
  return (int)cudaGetLastError();
}

int dropout_attn::launch_bwd_tf32x3(const Args& a, const float* out,
                                    const float* dout, const float* lse,
                                    float* delta, Grad dq, Grad dk, Grad dv,
                                    cudaStream_t s) {
  cudaError_t err = allow_smem(attn_dropout_bwd_dq_tf32x3_kernel, kDqBytes);
  if (err == cudaSuccess)
    err = allow_smem(attn_dropout_bwd_dkv_tf32x3_kernel, kDkvBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.L / kRows, a.H, a.B);
  attn_dropout_bwd_dq_tf32x3_kernel<<<grid, kMmaThreads, kDqBytes, s>>>(
      a.q, a.k, a.v, out, dout, lse, a.seed, delta, dq, a.L, a.scale,
      a.inv_keep, a.thresh, a.b0,
      vec16_f32(a.k.p, a.k.row) && vec16_f32(a.v.p, a.v.row));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_dropout_bwd_dkv_tf32x3_kernel<<<grid, kMmaThreads, kDkvBytes, s>>>(
      a.q, a.k, a.v, dout, lse, delta, a.seed, dk, dv, a.L, a.scale,
      a.inv_keep, a.thresh, a.b0,
      vec16_f32(a.q.p, a.q.row) && vec16_f32(dout, (int64_t)a.H * kDH));
  return (int)cudaGetLastError();
}
