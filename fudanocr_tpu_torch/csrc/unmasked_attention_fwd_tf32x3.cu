// The fp32 forward of the segmentation attention on the tensor cores in
// split TF32 (3xTF32), hand-written for Hopper (sm_90a): every fp32 call of
// the forward entries of csrc/unmasked_attention.cu (unmasked, region-
// masked and the training forward; B7, B6 and B5, and through B7's
// wrappers B3 and B10). It replaces, in fp32, the Pallas TPU kernels
// fudanocr_tpu/ops/region_attention.py `_plain_fwd` (:280) and
// `_region_fwd` (:167) and flash_attention.py `_mha_full` (:119) and
// `_flash_mha_impl` (:653). What bounds it (the products: 3 TF32 products
// per fp32 product at 495 TFLOP/s), why three TF32 products meet the fp32
// bar where one does not, and its design: the top of
// csrc/unmasked_attention.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "unmasked_attention.cuh"

namespace {

// The forward takes 64-row q tiles (4 warps a block) where 128-row tiles
// would give fewer blocks than this: two on each of an H100's 132 SMs
constexpr int kSmallGrid = 2 * 132;

// The fp32 forward: one block of blockDim.x / 32 warps (8 or 4) per
// (blockDim.x / 2 q rows, head, image), each warp 16 q rows; unmasked,
// MASKED, and STATS (o fp32 and the row max and 1/denominator into stat_m
// / stat_inv at ((b * H + h) * Lq + row)). vec16: k, v and o allow 16-byte
// copies and 8-byte stores.
template <int DH, bool MASKED, bool STATS>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? kTf32Blocks32 : 1)
attn_fwd_tf32x3_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       const float* __restrict__ rq,
                       const float* __restrict__ rkv,
                       float* __restrict__ stat_m,
                       float* __restrict__ stat_inv, int Lq, int Lkv,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, bool vec16) {
  constexpr int P = DH + 4, T = kTile * P, STAGE = kv_stage_floats<DH>();
  constexpr int KS = DH / 8, NS = kTile / 8, NO = DH / 8;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma group and lane in it
  const int64_t row0 = (int64_t)blockIdx.x * (blockDim.x / 2) + warp * 16;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ib = MASKED ? rkv + (int64_t)b * Lkv : nullptr;

  auto issue = [&](int j) {   // key tile j into stage j & 1
    float* st = smem + (j & 1) * STAGE;
    const int64_t k0 = (int64_t)j * kTile;
    copy_tile_f32<DH>(st, kb + k0 * sk.r, sk.r, vec16);
    copy_tile_f32<DH>(st + 2 * T, vb + k0 * sv.r, sv.r, vec16);
    if (MASKED && threadIdx.x < kTile)
      cp_async4(st + 4 * T + threadIdx.x, ib + k0 + threadIdx.x);
    cp_async_commit();
  };
  issue(0);
  AOperand<KS> qa;   // this warp's q rows, split once
  load_a(qa, q + b * sq.b + h * sq.h + row0 * sq.r, sq.r, g, t);
  float rid[2] = {0.f, 0.f};
  if (MASKED) {
    rid[0] = rq[(int64_t)b * Lq + row0 + g];
    rid[1] = rq[(int64_t)b * Lq + row0 + g + 8];
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
  // this lane's rows g (c = 0, 1) and g + 8 (c = 2, 3), keys n*8 + 2t +
  // (c & 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // two barriers per tile: after the first, tile j is in from every
  // thread's copies and every warp is done with tile j - 1, whose stage
  // tile j + 1 fills; after the second, tile j is split
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

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float c[1][4];
      mma3_abt<KS, 1, P>(c, qa, st + n * 8 * P, st + T + n * 8 * P, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = c[0][i];
    }
    // the scaled (and masked) fp32 scores, rounded as the CUDA-core kernels
    // round them, and the running max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = __fmul_rn(s[n][c], scale);
        if (MASKED)
          x = __fadd_rn(x, rid[c >> 1] == ids[n * 8 + 2 * t + (c & 1)]
                               ? kNeg : 0.f);
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m[rr], quad_max(mx[rr]));   // finite
      alpha[rr] = __expf(m[rr] - m_new);                    // 0 at tile 0
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
    for (int rr = 0; rr < 2; ++rr)
      l[rr] = l[rr] * alpha[rr] + quad_sum(sum[rr]);
    // this tile's P V from 0, then added to the rescaled running sum
    float part[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) part[n][0] = part[n][1] = part[n][2] =
        part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      mma3_xb<NO, P>(part, s[kk], st + 2 * T + kk * 8 * P,
                     st + 3 * T + kk * 8 * P, g, t);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n][c] = fmaf(acc[n][c], alpha[c >> 1], part[n][c]);
  }
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t row = row0 + g + 8 * hr;
    const float inv = 1.f / l[hr];
    float* orow = ob + row * so.r;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = acc[n][2 * hr] * inv, x1 = acc[n][2 * hr + 1] * inv;
      float* dst = orow + n * 8 + 2 * t;
      if (vec16) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        dst[0] = x0;
        dst[1] = x1;
      }
    }
    if (STATS && t == 0) {
      const int64_t r = ((int64_t)b * gridDim.y + h) * Lq + row;
      stat_m[r] = m[hr];
      stat_inv[r] = inv;
    }
  }
}

// every fp32 forward: the split-TF32 kernel
template <int DH, bool MASKED, bool STATS>
int launch_fwd_tf32(const FwdArgs& a, dim3 grid, cudaStream_t s) {
  auto* kernel = attn_fwd_tf32x3_kernel<DH, MASKED, STATS>;
  constexpr int bytes = 2 * kv_stage_floats<DH>() * (int)sizeof(float);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const bool v16 = aligned16_f32(a.k, a.sk) && aligned16_f32(a.v, a.sv) &&
                   aligned16_f32(a.o, a.so);
  int threads = kMmaThreads;
  if ((int64_t)grid.x * grid.y * grid.z < kSmallGrid) {
    grid.x *= 2;
    threads /= 2;
  }
  kernel<<<grid, threads, bytes, s>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.rq, a.rkv, a.stat_m, a.stat_inv, a.Lq, a.Lkv, a.sq, a.sk, a.sv,
      a.so, a.scale, v16);
  return (int)cudaGetLastError();
}

template <bool MASKED, bool STATS>
int launch_fwd_tf32_dh(const FwdArgs& a, int dh, dim3 grid, cudaStream_t s) {
  return dh == 32 ? launch_fwd_tf32<32, MASKED, STATS>(a, grid, s)
                  : launch_fwd_tf32<64, MASKED, STATS>(a, grid, s);
}

template <bool MASKED>
int launch_fwd_tf32_stats(const FwdArgs& a, int dh, bool stats, dim3 grid,
                          cudaStream_t s) {
  return stats ? launch_fwd_tf32_dh<MASKED, true>(a, dh, grid, s)
               : launch_fwd_tf32_dh<MASKED, false>(a, dh, grid, s);
}

}  // namespace

int seg_attn::launch_fwd_tf32x3(const FwdArgs& a, int dh, bool stats,
                                dim3 grid, cudaStream_t s) {
  return a.rq ? launch_fwd_tf32_stats<true>(a, dh, stats, grid, s)
              : launch_fwd_tf32_stats<false>(a, dh, stats, grid, s);
}
