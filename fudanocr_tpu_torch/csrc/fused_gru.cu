// Bidirectional GRU, both directions in one launch, every product on the
// tensor cores in split TF32, hand-written for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel fudanocr_tpu/ops/fused_gru.py:80
// `fused_bigru` (body `_gru_kernel`, :55-77) together with the input
// projections that JAX's `BiGRU` computes in front of it with XLA
// (fudanocr_tpu/nn/recurrent.py:76-122, `xf @ wi + bi`). The Python
// wrappers, their gates and the plain PyTorch versions live in
// fudanocr_tpu_torch/ops/fused_gru.py.
//
// The function. For rows b of x (B', T, C), bf16 or fp32, and per direction
// torch's GRU parameters in torch's own layout, W_i (3H, C), b_i (3H,),
// W_h (3H, H), b_h (3H,), gate blocks [r, z, n], h_0 = 0 and
//   p   = fp32(x_t) W_i^T + b_i,   g = h_{t-1} W_h^T + b_h      (fp32)
//   r   = sigmoid(p_r + g_r),  z = sigmoid(p_z + g_z)   sigmoid = 1/(1+e^-x)
//   n   = tanh(p_n + r * g_n)
//   h_t = (1 - z) * n + z * h_{t-1}
// the forward direction runs t = 0..T-1 into columns [0, H) of y (B', T,
// 2H), the backward direction t = T-1..0 into columns [H, 2H); y is fp32
// or bf16 (rounded to nearest even). A second entry takes the projections
// p (B', T, 3H) fp32 per direction instead of x (the projection switched
// off at compile time): the counterpart of JAX's `fused_bigru`, whose
// wrapper hands it JAX's (H, 3H) hidden weights transposed to torch's.
//
// What bounds it on this card. Per row and step both directions do
// 2 * (6HC + 6H^2) flops of products; at TSRN's C = 64, H = 32 and
// 262,144 row-steps (both of TSRN's shapes) that is 9.66 GFLOP, against
// 67 MB (bf16 x and y) or 134 MB (fp32) moved once. On the CUDA cores the
// products alone take 0.144 ms (0.152 with the gates), three times the
// bytes' 0.040 ms; on the tensor cores as three TF32 products they take
// 0.059 ms. Hence the tensor cores. A bf16 x's projection could take
// three bf16 products (W_i split three ways into bf16) at twice the TF32
// rate, 0.020 ms in place of three TF32 products' 0.039; that makes the
// bf16 floor 0.039 ms. This kernel gives a bf16 x two TF32 products (its
// TF32 low part is zero), 0.026 ms of the projection: 0.046 ms in all.
//
// The design.
//   * One block per 64 rows and direction, four warps, each warp owning 16
//     rows: the rows are the M dimension of mma.sync.m16n8k8 on TF32, the
//     gate columns (3H, in n-tiles of 8) the N dimension.
//   * Both weight matrices of the block's direction are split into TF32
//     hi + lo once per block into shared memory (86,784 B at H = 32, so
//     two blocks an SM), rows padded to a pitch of 8 mod 16 words so that
//     the B fragments, two adjacent words a lane, load without bank
//     conflicts. W_i's columns are padded with zeros to C = 64, so the
//     kernel is built once per H; a zero product leaves a sum unchanged.
//   * The k order inside every 8-column step is permuted, slot t -> column
//     2t and slot t + 4 -> column 2t + 1. Then h_t, which the gate math
//     leaves in the accumulator layout (a lane holds columns 2t, 2t + 1 of
//     rows g, g + 8), is already the A fragment of the next step's
//     product: no shuffle and no trip through shared memory; x's fragments
//     and the weights' B fragments are two adjacent elements a lane.
//   * Per step a warp computes the projection of its 16 rows (K = C) and
//     the recurrence (K = H), each from a zero accumulator (the tensor
//     cores round every mma's sum toward zero, so no sum runs across
//     steps), small products of every k-step first (x_lo W_hi and x_hi
//     W_lo, or only the latter for bf16 x), then the large ones. The CPU
//     model of these products, their order and rounding and the gates'
//     forms, tests/test_torch_gru_tf32x3_rounding.py, is within 1e-5 of
//     JAX's kernel at T = 64 also with |pre-activation| ~ 10 (up to ~50);
//     one TF32 product misses by ~100x. The model has the accurate
//     exponential and division; the card tests' saturating cases hold the
//     fast ones (tests/test_torch_tsrn.py, chip_smoke.py phase 19c). The
//     TF32 rounding is cvt.rna's, done as two integer operations (the
//     values are finite).
//   * All 3H columns' accumulators are live at once (projection and
//     recurrence, 24 of them at H = 32) and every k-step gives each one
//     mma in turn, so consecutive mmas are independent; only h W_h^T
//     (K = H) is serial in t. x of the next step is loaded into the
//     registers the projection has just consumed, behind the recurrence
//     and the gates.
//   * The gates are fp32 on the CUDA cores in the reference's order, on
//     the fast exponential and division: with expf, tanhf and IEEE
//     division the kernel takes 1.1-1.7x as long (scripts/
//     time_gru_paths.py --variants, accurate_gates).
//   * Occupancy at (4096, 64): 8,192 row-directions make 512 warps, 128
//     blocks, about 4 warps an SM, one per scheduler, so each warp keeps
//     its share of the tensor cores busy alone, on the independent mmas
//     above. At (16384, 16), 512 blocks at two an SM give 8 warps an SM
//     in two waves.
//   * Where the time goes (H100 SXM, 700 W): the 336 mmas a step of bf16
//     x (432 for fp32), at about the rate that this repository's other
//     mma.sync TF32 kernels reach; without the gates a bf16 call is 3-4 %
//     faster (fp32: 16-25 %). Registers and spills: scripts/
//     time_gru_paths.py --ptxas.
// H in {8, 16, 24, 32}, C a multiple of 8 up to 64; the wrappers refuse
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kGruWarps = 4;              // 16 rows each
constexpr int kGruRows = 16 * kGruWarps;  // rows per block
constexpr int kMaxC = 64;                 // input features of the projection
constexpr int kKC = kMaxC / 8;            // its k-steps (zero-padded)

// row pitch (words) of a K-column matrix in shared memory: 8 mod 16, so
// the 16 lanes of a half warp reading (row g, words 2t, 2t + 1) of rows
// g = 0..3 hit 32 different banks
__host__ __device__ constexpr int gru_pitch(int k) {
  return k % 16 == 8 ? k : k + 8;
}

struct GruArgs {
  const void* x;            // (rows, T, C) fp32 or bf16 (projection on)
  const float* xp[2];       // (rows, T, 3H) per direction (projection off)
  const float* wi[2];       // (3H, C) per direction
  const float* bi[2];       // (3H,)
  const float* wh[2];       // (3H, H)
  const float* bh[2];       // (3H,)
  void* y;                  // (rows, T, 2H) fp32 or bf16
  int rows, T, C;
};

template <int H, bool PROJ>
__host__ __device__ constexpr int gru_smem_words() {
  return (PROJ ? 2 * 3 * H * gru_pitch(kMaxC) + 3 * H : 0) +
         2 * 3 * H * gru_pitch(H) + 3 * H;
}

// The gates: sigmoid(x) = 1 / (1 + e^-x) and tanh(x) = 1 - 2 / (1 + e^2x)
// on the fast exponential and division, within ~3e-7 of the accurate
// functions (an absolute error in h, far inside the 1e-5 bar)
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_gate(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

// x rounded to TF32 as cvt.rna rounds a finite x (to nearest, ties away
// from zero), as the bits of an fp32; two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo in TF32, |x - hi - lo| < 2^-22 |x|
__device__ __forceinline__ void split_rna(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Split w (n, k) = src[n * K + k] into TF32 hi and lo at hi / lo[n * P + k]
// for n < N, k < K, zeros for K <= k < KP
template <int P>
__device__ __forceinline__ void stage_split(uint32_t* hi, uint32_t* lo,
                                            const float* __restrict__ src,
                                            int N, int K, int KP) {
  for (int e = threadIdx.x; e < N * KP; e += blockDim.x) {
    const int n = e / KP, k = e % KP;
    uint32_t h = 0, l = 0;
    if (k < K) split_rna(src[n * K + k], h, l);
    hi[n * P + k] = h;
    lo[n * P + k] = l;
  }
}

// x's A fragment of one k-step from the raw loads of rows g (r[0]) and
// g + 8 (r[1]), columns 8kk + 2t, + 1: a0 = (g, 2t), a1 = (g + 8, 2t),
// a2 = (g, 2t + 1), a3 = (g + 8, 2t + 1); fp32 split into hi + lo
__device__ __forceinline__ void x_frag(const float2 (&r)[2], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_rna(r[0].x, hi[0], lo[0]);
  split_rna(r[1].x, hi[1], lo[1]);
  split_rna(r[0].y, hi[2], lo[2]);
  split_rna(r[1].y, hi[3], lo[3]);
}
// bf16 pairs: exact in TF32 (a bf16 has 8 significant bits), lo = 0
__device__ __forceinline__ void x_frag(const uint32_t (&r)[2],
                                       uint32_t (&hi)[4], uint32_t (&)[4]) {
  hi[0] = r[0] << 16;
  hi[1] = r[1] << 16;
  hi[2] = r[0] & 0xffff0000u;
  hi[3] = r[1] & 0xffff0000u;
}

__device__ __forceinline__ void ld_pair(float2& d, const float* p) {
  d = *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void ld_pair(uint32_t& d, const __nv_bfloat16* p) {
  d = *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the B fragment (b0, b1) of n-tile row n, k-step kk of a split matrix at
// pitch P: words 8kk + 2t, + 1 of row n
__device__ __forceinline__ uint2 ldb2(const uint32_t* w, int off) {
  return *reinterpret_cast<const uint2*>(w + off);
}

// Load step tt's operands into registers: x's raw pairs of every k-step
// (projection on; zeros past C), or the projections' pairs of every
// n-tile (off), rows at xa / xb or pa / pb (already offset by 2t)
template <bool PROJ, typename Raw, typename XT, int KC, int NT>
__device__ __forceinline__ void load_step(Raw (&dx)[KC][2],
                                          float2 (&dp)[NT][2],
                                          const XT* xa, const XT* xb,
                                          const float* pa, const float* pb,
                                          int tt, int C, int kc, int G3) {
  if constexpr (PROJ) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (kk < kc) {
        ld_pair(dx[kk][0], xa + (int64_t)tt * C + 8 * kk);
        ld_pair(dx[kk][1], xb + (int64_t)tt * C + 8 * kk);
      } else {
        dx[kk][0] = dx[kk][1] = Raw{};
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      ld_pair(dp[n][0], pa + (int64_t)tt * G3 + 8 * n);
      ld_pair(dp[n][1], pb + (int64_t)tt * G3 + 8 * n);
    }
  }
}

// acc[n] += A B_n over one k-step for the NT n-tiles n of a split matrix
// at pitch P (B's fragment: rows 8n + g of whi / wlo, words off, off + 1;
// off = g P + 2t + 8kk): `small_step` the small products a_lo b_hi (if
// SMALL_A) and a_hi b_lo, `large_step` the large one a_hi b_hi. Every
// accumulator takes one mma in turn, so consecutive mmas are independent.
template <int NT, int P, bool SMALL_A>
__device__ __forceinline__ void small_step(float (&acc)[NT][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t* whi,
                                           const uint32_t* wlo, int off) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if constexpr (SMALL_A) {
      const uint2 b = ldb2(whi, off + 8 * n * P);
      mma_tf32(acc[n], al, b.x, b.y);
    }
    const uint2 b = ldb2(wlo, off + 8 * n * P);
    mma_tf32(acc[n], ah, b.x, b.y);
  }
}
template <int NT, int P>
__device__ __forceinline__ void large_step(float (&acc)[NT][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t* whi, int off) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint2 b = ldb2(whi, off + 8 * n * P);
    mma_tf32(acc[n], ah, b.x, b.y);
  }
}

template <int H, typename XT, typename YT, bool PROJ>
__global__ void __launch_bounds__(32 * kGruWarps, 2)
bigru_tf32x3_kernel(const GruArgs a) {
  constexpr int NH = H / 8;              // n-tiles per gate, k-steps of h
  constexpr int G3 = 3 * H;
  constexpr int PC = gru_pitch(kMaxC), PH = gru_pitch(H);
  constexpr bool kSplitX = std::is_same<XT, float>::value;
  using Raw = typename std::conditional<kSplitX, float2, uint32_t>::type;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* whh_hi = smem;
  uint32_t* whh_lo = whh_hi + G3 * PH;
  float* bhs = reinterpret_cast<float*>(whh_lo + G3 * PH);
  uint32_t* wih_hi = reinterpret_cast<uint32_t*>(bhs + G3);
  uint32_t* wih_lo = wih_hi + G3 * PC;
  float* bis = reinterpret_cast<float*>(wih_lo + G3 * PC);

  const int dir = blockIdx.y;
  const float* wh = dir ? a.wh[1] : a.wh[0];
  const float* bh = dir ? a.bh[1] : a.bh[0];
  stage_split<PH>(whh_hi, whh_lo, wh, G3, H, H);
  for (int e = threadIdx.x; e < G3; e += blockDim.x) bhs[e] = bh[e];
  if constexpr (PROJ) {
    const float* bi = dir ? a.bi[1] : a.bi[0];
    stage_split<PC>(wih_hi, wih_lo, dir ? a.wi[1] : a.wi[0], G3, a.C, kMaxC);
    for (int e = threadIdx.x; e < G3; e += blockDim.x) bis[e] = bi[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kGruWarps + warp) * 16;
  if (row0 >= a.rows) return;   // whole warps; no block barrier below
  const int ra = row0 + g, rb = row0 + g + 8;
  // rows past the end read the last row (an mma's rows are independent)
  // and store nothing
  const int64_t la = min(ra, a.rows - 1), lb = min(rb, a.rows - 1);
  const int T = a.T;
  const int64_t ystride = (int64_t)T * 2 * H;

  // x (projection on) or the projections (off) of rows ra, rb at step tt
  const XT* xa = nullptr;
  const XT* xb = nullptr;
  const float* pa = nullptr;
  const float* pb = nullptr;
  if constexpr (PROJ) {
    xa = static_cast<const XT*>(a.x) + la * T * a.C + 2 * t;
    xb = static_cast<const XT*>(a.x) + lb * T * a.C + 2 * t;
  } else {
    const float* xp = dir ? a.xp[1] : a.xp[0];
    pa = xp + la * T * G3 + 2 * t;
    pb = xp + lb * T * G3 + 2 * t;
  }
  const int kc = a.C / 8;
  Raw xr[kKC][2];            // x of the step (projection on)
  float2 pr[3 * NH][2];      // the projections of the step (off)
  float h[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
  int tt = dir ? T - 1 : 0;
  load_step<PROJ>(xr, pr, xa, xb, pa, pb, tt, a.C, kc, G3);
  for (int i = 0; i < T; ++i) {
    // h_{t-1} in the accumulator layout is the A fragment of k-step j
    // (columns 8j + 2t, + 1 in slots t, t + 4)
    uint32_t hh[NH][4], hl[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      split_rna(h[j][0], hh[j][0], hl[j][0]);
      split_rna(h[j][2], hh[j][1], hl[j][1]);
      split_rna(h[j][1], hh[j][2], hl[j][2]);
      split_rna(h[j][3], hh[j][3], hl[j][3]);
    }
    // p: the projections of all 3H columns, q: h W_h^T; every sum from zero,
    // the small products of every k-step first, then the large ones
    float p[3 * NH][4], q[3 * NH][4];
#pragma unroll
    for (int n = 0; n < 3 * NH; ++n) {
      q[n][0] = q[n][1] = q[n][2] = q[n][3] = 0.f;
      if constexpr (PROJ) {
        p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      } else {
        p[n][0] = pr[n][0].x;
        p[n][1] = pr[n][0].y;
        p[n][2] = pr[n][1].x;
        p[n][3] = pr[n][1].y;
      }
    }
    const int oh = g * PH + 2 * t, oc = g * PC + 2 * t;
    if constexpr (PROJ) {
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        uint32_t xh[4], xl[4];
        x_frag(xr[kk], xh, xl);
        small_step<3 * NH, PC, kSplitX>(p, xh, xl, wih_hi, wih_lo,
                                        oc + 8 * kk);
      }
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        uint32_t xh[4], xl[4];
        x_frag(xr[kk], xh, xl);
        large_step<3 * NH, PC>(p, xh, wih_hi, oc + 8 * kk);
      }
    }
    // the next step's loads, into the registers this step is done with;
    // the recurrence and the gates cover their latency
    const int tn = i + 1 < T ? (dir ? tt - 1 : tt + 1) : tt;
    load_step<PROJ>(xr, pr, xa, xb, pa, pb, tn, a.C, kc, G3);
#pragma unroll
    for (int kk = 0; kk < NH; ++kk)
      small_step<3 * NH, PH, true>(q, hh[kk], hl[kk], whh_hi, whh_lo,
                                   oh + 8 * kk);
#pragma unroll
    for (int kk = 0; kk < NH; ++kk)
      large_step<3 * NH, PH>(q, hh[kk], whh_hi, oh + 8 * kk);

    // the gates, fp32, in the reference's order; then y of this step
#pragma unroll
    for (int j = 0; j < NH; ++j) {   // hidden units 8j .. 8j + 7
      const int col = 8 * j + 2 * t;
      float2 bi[3], bh[3];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        bh[gate] = *reinterpret_cast<const float2*>(bhs + gate * H + col);
        bi[gate] = PROJ ? *reinterpret_cast<const float2*>(bis + gate * H + col)
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        float x3[3], g3[3];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const float pg = p[gate * NH + j][e];
          x3[gate] = PROJ ? pg + (odd ? bi[gate].y : bi[gate].x) : pg;
          g3[gate] = q[gate * NH + j][e] + (odd ? bh[gate].y : bh[gate].x);
        }
        const float r = sigmoid(x3[0] + g3[0]);
        const float z = sigmoid(x3[1] + g3[1]);
        const float nn = tanh_gate(x3[2] + r * g3[2]);
        h[j][e] = (1.f - z) * nn + z * h[j][e];
      }
      YT* y = static_cast<YT*>(a.y) + (int64_t)tt * 2 * H + dir * H + col;
      if (ra < a.rows) store_pair(y + ra * ystride, h[j][0], h[j][1]);
      if (rb < a.rows) store_pair(y + rb * ystride, h[j][2], h[j][3]);
    }
    tt = tn;
  }
}

template <int H, typename XT, typename YT, bool PROJ>
int launch(const GruArgs& a, cudaStream_t s) {
  auto* kernel = bigru_tf32x3_kernel<H, XT, YT, PROJ>;
  const int bytes = 4 * gru_smem_words<H, PROJ>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.rows + kGruRows - 1) / kGruRows, 2);
  kernel<<<grid, 32 * kGruWarps, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename XT, typename YT, bool PROJ>
int launch_h(const GruArgs& a, int hidden, cudaStream_t s) {
  switch (hidden) {
    case 8:
      return launch<8, XT, YT, PROJ>(a, s);
    case 16:
      return launch<16, XT, YT, PROJ>(a, s);
    case 24:
      return launch<24, XT, YT, PROJ>(a, s);
    case 32:
      return launch<32, XT, YT, PROJ>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y (rows, T, 2H) fp32 = both directions of the GRU over the projections
// xproj_f / xproj_b (rows, T, 3H) fp32 with torch's (3H, H) hidden weights
// whf / whb and (3H,) biases, all contiguous; returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int gru_bidir_fwd(const void* xf, const void* xb, const void* whf,
                             const void* bhf, const void* whb,
                             const void* bhb, void* y, int rows, int T,
                             int hidden, void* stream) {
  if (rows < 1 || T < 1) return (int)cudaErrorInvalidValue;
  GruArgs a = {};
  a.xp[0] = (const float*)xf;
  a.xp[1] = (const float*)xb;
  a.wh[0] = (const float*)whf;
  a.wh[1] = (const float*)whb;
  a.bh[0] = (const float*)bhf;
  a.bh[1] = (const float*)bhb;
  a.y = y;
  a.rows = rows;
  a.T = T;
  return launch_h<float, float, false>(a, hidden, (cudaStream_t)stream);
}

// y (rows, T, 2H), bf16 if y_bf16 else fp32, = the bidirectional GRU over
// x (rows, T, C), bf16 if x_bf16 else fp32, with torch's parameters per
// direction: wi (3H, C), bi (3H,), wh (3H, H), bh (3H,), fp32, all
// contiguous; C a multiple of 8 up to 64. Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int gru_bidir_x_fwd(const void* x, const void* wif,
                               const void* bif, const void* whf,
                               const void* bhf, const void* wib,
                               const void* bib, const void* whb,
                               const void* bhb, void* y, int rows, int T,
                               int C, int hidden, int x_bf16, int y_bf16,
                               void* stream) {
  if (rows < 1 || T < 1 || C < 8 || C > kMaxC || C % 8)
    return (int)cudaErrorInvalidValue;
  GruArgs a = {};
  a.x = x;
  a.wi[0] = (const float*)wif;
  a.wi[1] = (const float*)wib;
  a.bi[0] = (const float*)bif;
  a.bi[1] = (const float*)bib;
  a.wh[0] = (const float*)whf;
  a.wh[1] = (const float*)whb;
  a.bh[0] = (const float*)bhf;
  a.bh[1] = (const float*)bhb;
  a.y = y;
  a.rows = rows;
  a.T = T;
  a.C = C;
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16)   // fp32 x gives fp32 y
    return y_bf16 ? (int)cudaErrorInvalidValue
                  : launch_h<float, float, true>(a, hidden, s);
  return y_bf16 ? launch_h<__nv_bfloat16, __nv_bfloat16, true>(a, hidden, s)
                : launch_h<__nv_bfloat16, float, true>(a, hidden, s);
}
