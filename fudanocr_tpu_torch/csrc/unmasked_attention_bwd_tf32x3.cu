// The fp32 backward of the segmentation attention on the tensor cores in
// split TF32 (3xTF32), hand-written for Hopper (sm_90a): launches 1 (dQ and
// D) and 2 (the dK/dV partials) of every fp32 call of `attn_packed_bwd`
// (csrc/unmasked_attention.cu, which then sums the partials). It replaces,
// in fp32, the Pallas TPU kernels fudanocr_tpu/ops/region_attention.py
// `_plain_bwd` (:306) and `_region_bwd` (:201). What bounds it (the five
// products, 3 TF32 products each at 495 TFLOP/s), why three TF32 products
// meet the fp32 bar where one does not, and its design: the top of
// csrc/unmasked_attention.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "unmasked_attention.cuh"

namespace {

// Backward launch 1 in fp32: dq (B, Lq, H*DH) contiguous, and D_i =
// dO_i . o_i into delta, for this warp's 16 q rows against every key;
// dout and o (fp32) contiguous (B, Lq, H*DH). The key tile is taken in
// chunks of 16 keys; dq's running sum lives in shared memory. vec16: k and
// v allow 16-byte copies.
template <int DH, bool MASKED>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? kTf32Blocks32 : 1)
attn_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ o,
                          const float* __restrict__ dout,
                          const float* __restrict__ rq,
                          const float* __restrict__ rkv,
                          const float* __restrict__ stat_m,
                          const float* __restrict__ stat_inv,
                          float* __restrict__ delta, float* __restrict__ dq,
                          int Lq, int Lkv, Strides sq, Strides sk,
                          Strides sv, float scale, bool vec16) {
  constexpr int P = DH + 4, T = kTile * P, STAGE = kv_stage_floats<DH>();
  constexpr int KS = DH / 8, NO = DH / 8;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t D = (int64_t)gridDim.y * DH;
  const int64_t row0 = (int64_t)blockIdx.x * kRows + warp * 16;
  const int64_t srow0 = ((int64_t)b * gridDim.y + h) * Lq + row0;
  const int64_t prow0 = ((int64_t)b * Lq + row0) * D + h * DH;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ib = MASKED ? rkv + (int64_t)b * Lkv : nullptr;
  float* mine = smem + 2 * STAGE + (warp * 16 + g) * P + 2 * t;

  auto issue = [&](int j) {
    float* st = smem + (j & 1) * STAGE;
    const int64_t k0 = (int64_t)j * kTile;
    copy_tile_f32<DH>(st, kb + k0 * sk.r, sk.r, vec16);
    copy_tile_f32<DH>(st + 2 * T, vb + k0 * sv.r, sv.r, vec16);
    if (MASKED && threadIdx.x < kTile)
      cp_async4(st + 4 * T + threadIdx.x, ib + k0 + threadIdx.x);
    cp_async_commit();
  };
  issue(0);
  AOperand<KS> qa, da;
  load_a(qa, q + b * sq.b + h * sq.h + row0 * sq.r, sq.r, g, t);
  // dO's fragments, and D_i over this lane's features, then the quad
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t off =
          prow0 + (g + 8 * (i & 1)) * D + kk * 8 + t + 4 * (i >> 1);
      const float x = dout[off];
      di[i & 1] = fmaf(x, o[off], di[i & 1]);
      split_tf32(x, da.h[kk][i], da.l[kk][i]);
    }
  float m[2], inv[2], rid[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    di[rr] = quad_sum(di[rr]);
    m[rr] = stat_m[srow0 + g + 8 * rr];
    inv[rr] = stat_inv[srow0 + g + 8 * rr];
    if (MASKED) rid[rr] = rq[(int64_t)b * Lq + row0 + g + 8 * rr];
    if (t == 0) delta[srow0 + g + 8 * rr] = di[rr];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    mine[n * 8] = mine[n * 8 + 1] = 0.f;
    mine[8 * P + n * 8] = mine[8 * P + n * 8 + 1] = 0.f;
  }

  const int tiles = Lkv / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    float* st = smem + (j & 1) * STAGE;
    split_tile<DH>(st, st + T);
    split_tile<DH>(st + 2 * T, st + 3 * T);
    __syncthreads();
    const float* ids = st + 4 * T;
    float part[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) part[n][0] = part[n][1] = part[n][2] =
        part[n][3] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kTile / 8; c0 += 2) {   // 16 keys at a time
      const int r0 = c0 * 8 * P;
      float s[2][4], dp[2][4];
      mma3_abt<KS, 2, P>(s, qa, st + r0, st + T + r0, g, t);
      mma3_abt<KS, 2, P>(dp, da, st + 2 * T + r0, st + 3 * T + r0, g, t);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = __fmul_rn(s[i][c], scale);
          if (MASKED)
            x = __fadd_rn(x, rid[c >> 1] ==
                                     ids[(c0 + i) * 8 + 2 * t + (c & 1)]
                                 ? kNeg : 0.f);
          const float p = __expf(x - m[c >> 1]) * inv[c >> 1];
          s[i][c] = p * (dp[i][c] - di[c >> 1]);   // dS
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)   // dQ += dS K
        mma3_xb<NO, P>(part, s[i], st + r0 + i * 8 * P,
                       st + T + r0 + i * 8 * P, g, t);
    }
    add_to<NO, P>(mine, part);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* dst = dq + prow0 + (g + 8 * hr) * D + 2 * t;
    const float* src = mine + hr * 8 * P;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(src[n * 8] * scale, src[n * 8 + 1] * scale);
  }
}

// Backward launch 2 in fp32: this warp's 16 keys against the q rows
// [split * q_chunk, min(Lq, (split + 1) * q_chunk)), block x = split *
// (Lkv / kRows) + key block; the q tile in chunks of 16 rows, dk's and dv's
// running sums in shared memory. Writes unscaled fp32 partial dk and dv at
// ((split * B + b) * Lkv + key) * H*DH + h*DH. vec16: q and dout allow
// 16-byte copies.
template <int DH, bool MASKED>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? kTf32Blocks32 : 1)
attn_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ rq,
                           const float* __restrict__ rkv,
                           const float* __restrict__ stat_m,
                           const float* __restrict__ stat_inv,
                           const float* __restrict__ delta,
                           float* __restrict__ dk_part,
                           float* __restrict__ dv_part, int Lq, int Lkv,
                           int q_chunk, Strides sq, Strides sk, Strides sv,
                           float scale, bool vec16) {
  constexpr int P = DH + 4, T = kTile * P, STAGE = q_stage_floats<DH>();
  constexpr int KS = DH / 8, NO = DH / 8;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int H = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t D = (int64_t)H * DH;
  const int nkb = Lkv / kRows;
  const int split = blockIdx.x / nkb;
  const int64_t key0 = (int64_t)(blockIdx.x % nkb) * kRows + warp * 16;
  const int q0 = split * q_chunk;
  const int q1 = min(Lq, q0 + q_chunk);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + (int64_t)b * Lq * D + h * DH;
  const int64_t sbase = ((int64_t)b * H + h) * Lq;
  float* dk_mine = smem + 2 * STAGE + (warp * 16 + g) * P + 2 * t;
  float* dv_mine = dk_mine + kRows * P;

  // q tile j into stage j & 1: Q and dO rows, and the rows' m, 1/l, D and
  // ids
  auto issue = [&](int j) {
    float* st = smem + (j & 1) * STAGE;
    const int64_t r0 = q0 + (int64_t)j * kTile;
    copy_tile_f32<DH>(st, qb + r0 * sq.r, sq.r, vec16);
    copy_tile_f32<DH>(st + 2 * T, dob + r0 * D, D, vec16);
    if (threadIdx.x < (MASKED ? 4 : 3) * kTile) {
      const int w = threadIdx.x / kTile, r = threadIdx.x % kTile;
      const float* src = w == 0 ? stat_m + sbase
                         : w == 1 ? stat_inv + sbase
                         : w == 2 ? delta + sbase
                                  : rq + (int64_t)b * Lq;
      cp_async4(st + 4 * T + threadIdx.x, src + r0 + r);
    }
    cp_async_commit();
  };
  issue(0);
  AOperand<KS> ka, va;   // this warp's keys
  load_a(ka, k + b * sk.b + h * sk.h + key0 * sk.r, sk.r, g, t);
  load_a(va, v + b * sv.b + h * sv.h + key0 * sv.r, sv.r, g, t);
  float rkey[2] = {0.f, 0.f};
  if (MASKED) {
    rkey[0] = rkv[(int64_t)b * Lkv + key0 + g];
    rkey[1] = rkv[(int64_t)b * Lkv + key0 + g + 8];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk_mine[n * 8] = dk_mine[n * 8 + 1] = 0.f;
    dk_mine[8 * P + n * 8] = dk_mine[8 * P + n * 8 + 1] = 0.f;
    dv_mine[n * 8] = dv_mine[n * 8 + 1] = 0.f;
    dv_mine[8 * P + n * 8] = dv_mine[8 * P + n * 8 + 1] = 0.f;
  }

  const int tiles = (q1 - q0) / kTile;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < tiles) issue(j + 1);
    float* st = smem + (j & 1) * STAGE;
    split_tile<DH>(st, st + T);
    split_tile<DH>(st + 2 * T, st + 3 * T);
    __syncthreads();
    const float* sm_m = st + 4 * T;
    const float* sm_inv = sm_m + kTile;
    const float* sm_d = sm_m + 2 * kTile;
    const float* sm_id = sm_m + 3 * kTile;
    float kp[NO][4], vp[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) kp[n][c] = vp[n][c] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kTile / 8; c0 += 2) {   // 16 q rows at a time
      const int r0 = c0 * 8 * P;
      // S^T = K Q^T and dP^T = V dO^T: element (i, c) is key g + 8 (c >> 1)
      // and q row (c0 + i) * 8 + 2t + (c & 1) of the tile
      float s[2][4], dp[2][4];
      mma3_abt<KS, 2, P>(s, ka, st + r0, st + T + r0, g, t);
      mma3_abt<KS, 2, P>(dp, va, st + 2 * T + r0, st + 3 * T + r0, g, t);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = (c0 + i) * 8 + 2 * t + (c & 1);
          float x = __fmul_rn(s[i][c], scale);
          if (MASKED)
            x = __fadd_rn(x, sm_id[qc] == rkey[c >> 1] ? kNeg : 0.f);
          const float p = __expf(x - sm_m[qc]) * sm_inv[qc];
          s[i][c] = p;
          dp[i][c] = p * (dp[i][c] - sm_d[qc]);   // dS^T
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ri = r0 + i * 8 * P;
        mma3_xb<NO, P>(vp, s[i], st + 2 * T + ri, st + 3 * T + ri, g, t);
        mma3_xb<NO, P>(kp, dp[i], st + ri, st + T + ri, g, t);
      }
    }
    add_to<NO, P>(dk_mine, kp);
    add_to<NO, P>(dv_mine, vp);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t out =
        ((int64_t)(split * gridDim.z + b) * Lkv + key0 + g + 8 * hr) * D +
        h * DH + 2 * t;
    const float* sk_ = dk_mine + hr * 8 * P;
    const float* sv_ = dv_mine + hr * 8 * P;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(dk_part + out + n * 8) =
          make_float2(sk_[n * 8], sk_[n * 8 + 1]);
      *reinterpret_cast<float2*>(dv_part + out + n * 8) =
          make_float2(sv_[n * 8], sv_[n * 8 + 1]);
    }
  }
}

template <int DH, bool MASKED>
int launch_bwd_tf32(const BwdArgs& a, int splits, cudaStream_t s) {
  constexpr int P = DH + 4;
  constexpr int dq_bytes =
      (2 * kv_stage_floats<DH>() + kRows * P) * (int)sizeof(float);
  constexpr int dkv_bytes =
      (2 * q_stage_floats<DH>() + 2 * kRows * P) * (int)sizeof(float);
  auto* dq_kernel = attn_bwd_dq_tf32x3_kernel<DH, MASKED>;
  auto* dkv_kernel = attn_bwd_dkv_tf32x3_kernel<DH, MASKED>;
  cudaError_t err = allow_smem(dq_kernel, dq_bytes);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel, dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const float *q = (const float*)a.q, *k = (const float*)a.k,
              *v = (const float*)a.v;
  dq_kernel<<<dim3(a.Lq / kRows, a.H, a.B), kMmaThreads, dq_bytes, s>>>(
      q, k, v, a.o, (const float*)a.dout, a.rq, a.rkv, a.stat_m, a.stat_inv,
      a.delta, (float*)a.dq, a.Lq, a.Lkv, a.sq, a.sk, a.sv, a.scale,
      aligned16_f32(k, a.sk) && aligned16_f32(v, a.sv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<dim3(splits * (a.Lkv / kRows), a.H, a.B), kMmaThreads,
               dkv_bytes, s>>>(
      q, k, v, (const float*)a.dout, a.rq, a.rkv, a.stat_m, a.stat_inv,
      a.delta, a.dk_part, a.dv_part, a.Lq, a.Lkv, a.q_chunk, a.sq, a.sk,
      a.sv, a.scale,
      aligned16_f32(q, a.sq) &&
          aligned16_f32(a.dout, {(int64_t)a.Lq * a.H * DH, DH, a.H * DH}));
  return (int)cudaGetLastError();
}

}  // namespace

int seg_attn::launch_bwd_tf32x3(const BwdArgs& a, int dh, int splits,
                                cudaStream_t s) {
  if (a.rq)
    return dh == 32 ? launch_bwd_tf32<32, true>(a, splits, s)
                    : launch_bwd_tf32<64, true>(a, splits, s);
  return dh == 32 ? launch_bwd_tf32<32, false>(a, splits, s)
                  : launch_bwd_tf32<64, false>(a, splits, s);
}
