// The 3x3 convolutions of the whole TBSRN residual block (SRB) at
// inference, hand-written for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the convolution part of the Pallas TPU kernel
// fudanocr_tpu/ops/fused_srb.py:124 `fused_srb` (pallas_call at :153, body
// `_srb_kernel` :102, convolutions `_conv3x3` :63). The rest of that kernel,
// the enhancer and the block residual, runs through the two kernels of
// csrc/fused_enhancer.cu, whose epilogue takes the residual. The Python
// wrapper, the BN folding and the plain PyTorch version live in
// fudanocr_tpu_torch/ops/fused_srb.py. One SRB call is four launches:
//   srb_conv3x3 (mish)  r1 = T(mish(conv3x3(x, W1') + b1'))
//   srb_conv3x3         r  = T(conv3x3(r1, W2') + b2')
//   fe_qkv_proj         qkv of the enhancer on r
//   fe_attn_epilogue    out = T(x + enhancer(r)), the projection kept fp32
//
// Layout: the feature map is channels-last (B, H, W, C = 64), i.e. per image
// the row-major (L = H*W, 64) token matrix; W' is (9*64, 64) with tap
// (dy+1)*3 + (dx+1) in rows [tap*64, tap*64 + 64), the BN-folded weights of
// the torch OIHW conv (cross-correlation, no flip). Output token r = h*W + w
// reads token r + dy*W + dx where h + dy and w + dx lie inside the image;
// as a flat index that is: r + dy*W + dx in [0, L) and w + dx in [0, W).
//
// One block per 128 output tokens of one image (L is a multiple of 256,
// so a block never straddles two images) and all 64 output channels: an
// implicit GEMM (128, 576) x (576, 64). The block stages three bands of
// 130 input tokens, band dy+1 starting at flat token r0 + dy*W - 1, with
// zeros outside [0, L) (any W: the bands do not depend on it), and masks
// the W edge per output row and tap. Per tap it stages that tap's (64, 64)
// weights, then accumulates in fp32.
//
// What bounds it on this card: per call 2*L*576*64 flops per image against
// 2*L*64 elements moved, ~576 flops per element (~290 per byte in bf16):
// at the ridge in bf16, compute-bound in fp32. What the design does about
// it: in bf16 the products run on the tensor cores through mma.sync
// m16n8k16 with fp32 accumulators (8 warps, 16 output rows each); in fp32
// as CUDA-core FMAs with 8x4 register tiles (tensor-core TF32 would miss
// the fp32 tolerance). No wgmma, TMA or pipelining of the weight taps yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kC = 64;            // channels in and out
constexpr int kRows = 128;        // output tokens per block
constexpr int kBand = kRows + 2;  // tokens per staged band (dx = -1 .. +1)
constexpr int kThreads = 256;

// mish in fp32: v * tanh(softplus(v)), with softplus(v) computed as
// log1p(exp(-|v|)) + max(v, 0)
__device__ __forceinline__ float mish(float v) {
  return v * tanhf(log1pf(expf(-fabsf(v))) + fmaxf(v, 0.f));
}

// Stage the three bands of 130 tokens (row stride S elements) with 16-byte
// copies; tokens outside [0, L) are zeros.
template <typename T, int S>
__device__ __forceinline__ void stage_bands(const T* __restrict__ x,
                                            size_t img, int r0, int L, int W,
                                            T* bands) {
  constexpr int V = 16 / sizeof(T);   // elements per 16-byte copy
  for (int e = threadIdx.x; e < 3 * kBand * (kC / V); e += kThreads) {
    const int row = e / (kC / V), c = (e % (kC / V)) * V;
    const int band = row / kBand, j = row % kBand;
    const int f = r0 + (band - 1) * W - 1 + j;
    *reinterpret_cast<uint4*>(bands + row * S + c) =
        f >= 0 && f < L ? *reinterpret_cast<const uint4*>(
                              x + (img + f) * kC + c)
                        : make_uint4(0, 0, 0, 0);
  }
}

// Stage tap `tap` of W' ((64, 64) rows [tap*64, tap*64 + 64)), row stride S.
template <typename T, int S>
__device__ __forceinline__ void stage_tap(const T* __restrict__ w, int tap,
                                          T* ws) {
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < kC * (kC / V); e += kThreads) {
    const int k = e / (kC / V), c = (e % (kC / V)) * V;
    *reinterpret_cast<uint4*>(ws + k * S + c) =
        *reinterpret_cast<const uint4*>(w + (size_t)(tap * kC + k) * kC + c);
  }
}

// ---- fp32: CUDA-core FMAs --------------------------------------------------
// Thread (ty, tx) owns output rows ty + 16*i (i < 8) and columns tx + 16*j
// (j < 4). The band row stride 68 keeps 16-byte rows and puts the two rows a
// warp reads at once (ty, ty + 1) in different banks.
constexpr int kSF = kC + 4;
constexpr int kSmemF32 = (3 * kBand * kSF + kC * kC) * 4;

template <bool MISH>
__global__ void __launch_bounds__(kThreads)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int L, int W) {
  extern __shared__ __align__(16) float smem_f[];
  float* bands = smem_f;
  float* ws = smem_f + 3 * kBand * kSF;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * kRows;
  const size_t img = (size_t)blockIdx.y * L;
  stage_bands<float, kSF>(x, img, r0, L, W, bands);
  // W-edge validity of this thread's rows: bit i for dx = -1 (w > 0), bit
  // 8 + i for dx = +1 (w < W - 1)
  unsigned edge = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int wc = (r0 + ty + 16 * i) % W;
    edge |= (wc > 0 ? 1u : 0u) << i;
    edge |= (wc < W - 1 ? 1u : 0u) << (8 + i);
  }
  float acc[8][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __syncthreads();   // the previous tap's weights are consumed
    stage_tap<float, kC>(w, tap, ws);
    __syncthreads();
    const unsigned ok = dx < 0 ? edge & 0xffu : dx > 0 ? edge >> 8 : 0xffu;
    const float* band = bands + ((dy + 1) * kBand + ty + dx + 1) * kSF;
#pragma unroll 4
    for (int k = 0; k < kC; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = (ok >> i) & 1u ? band[16 * i * kSF + k] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k * kC + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float v = acc[i][j] + bias[c];
      out[(img + r0 + ty + 16 * i) * kC + c] = MISH ? mish(v) : v;
    }
}

// ---- bf16: tensor cores through mma.sync m16n8k16 --------------------------
// Warp w owns output rows 16w .. 16w + 15 and all 64 columns (8 n-tiles).
// A fragments are 32-bit loads from the bands (zeroed where the W edge
// masks the row), B fragments come through ldmatrix.trans from the staged
// tap; the row stride 72 (144 bytes) keeps both free of bank conflicts.
constexpr int kSB = kC + 8;
constexpr int kSmemBf16 = (3 * kBand * kSB + kC * kSB) * 2;

template <bool MISH>
__global__ void __launch_bounds__(kThreads)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int L, int W) {
  extern __shared__ __align__(16) __nv_bfloat16 smem_h[];
  __nv_bfloat16* bands = smem_h;
  __nv_bfloat16* ws = smem_h + 3 * kBand * kSB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows;
  const size_t img = (size_t)blockIdx.y * L;
  const int row = 16 * warp + g;   // this lane's rows: row, row + 8
  stage_bands<__nv_bfloat16, kSB>(x, img, r0, L, W, bands);
  const int wlo = (r0 + row) % W, whi = (r0 + row + 8) % W;
  float acc[8][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __syncthreads();   // the previous tap's weights are consumed
    stage_tap<__nv_bfloat16, kSB>(w, tap, ws);
    __syncthreads();
    const bool ok_lo = dx < 0 ? wlo > 0 : dx > 0 ? wlo < W - 1 : true;
    const bool ok_hi = dx < 0 ? whi > 0 : dx > 0 ? whi < W - 1 : true;
    const __nv_bfloat16* a_lo =
        bands + ((dy + 1) * kBand + row + dx + 1) * kSB + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
      const __nv_bfloat16* a = a_lo + ks * 16;
      const uint32_t af[4] = {ok_lo ? ld32(a) : 0u,
                              ok_hi ? ld32(a + 8 * kSB) : 0u,
                              ok_lo ? ld32(a + 8) : 0u,
                              ok_hi ? ld32(a + 8 * kSB + 8) : 0u};
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * kSB + n * 8 +
                                 (lane >> 4) * 8);
        mma_bf16(acc[n], af, b[0], b[1]);
        mma_bf16(acc[n + 1], af, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    __nv_bfloat16* dst = out + (img + r0 + row + 8 * hr) * kC + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float v0 = acc[n][2 * hr] + bias[n * 8 + 2 * t];
      float v1 = acc[n][2 * hr + 1] + bias[n * 8 + 2 * t + 1];
      if (MISH) {
        v0 = mish(v0);
        v1 = mish(v1);
      }
      __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = p;
    }
  }
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, const float*, T*, int, int),
           int bytes, dim3 grid, cudaStream_t s, const void* x, const void* w,
           const void* b, void* out, int L, int W) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, s>>>((const T*)x, (const T*)w,
                                       (const float*)b, (T*)out, L, W);
  return (int)cudaGetLastError();
}

}  // namespace

// out = T(act(conv3x3(x, W') + b')) over B channels-last (H, W, 64) maps, act
// mish when `mish` is nonzero, else the identity. x and out (B, H*W, 64) at
// T (bf16 when `bf16` is nonzero, else fp32), contiguous and 16-byte
// aligned, W' (576, 64) at T, b' (64) fp32. H*W must be a positive multiple
// of 128 (the SRB gate admits multiples of 256). Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int srb_conv3x3(const void* x, const void* w, const void* b,
                           void* out, int B, int H, int W, int mish,
                           int bf16, void* stream) {
  const int L = H * W;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || L % kRows)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(L / kRows, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch(mish ? conv3x3_mma_kernel<true> : conv3x3_mma_kernel<false>,
                  kSmemBf16, grid, s, x, w, b, out, L, W);
  return launch(mish ? conv3x3_fma_kernel<true> : conv3x3_fma_kernel<false>,
                kSmemF32, grid, s, x, w, b, out, L, W);
}
