// Bidirectional GRU recurrence over pre-projected inputs, both directions
// in one launch, hand-written for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel fudanocr_tpu/ops/fused_gru.py:80
// `fused_bigru` (body `_gru_kernel`, :55-77). The Python wrapper, its gate
// and the plain PyTorch version live in fudanocr_tpu_torch/ops/fused_gru.py.
//
// For rows b of xproj_f, xproj_b (B', T, 3H) fp32 (the hoisted input
// projections x @ W_i + b_i, gate blocks [r, z, n]), hidden weights
// wh (H, 3H) and biases bh (3H,) per direction, h_0 = 0 and
//   g   = h_{t-1} @ wh + bh                           (fp32)
//   r   = sigmoid(x_r + g_r),  z = sigmoid(x_z + g_z)  sigmoid = 1/(1+e^-x)
//   n   = tanh(x_n + r * g_n)
//   h_t = (1 - z) * n + z * h_{t-1}
// the forward direction runs t = 0..T-1 into columns [0, H) of y (B', T, 2H)
// fp32, the backward direction t = T-1..0 into columns [H, 2H).
//
// What bounds it on this card: per row and step 6H^2 + ~10*3H flops
// against 2*3H + 2H floats moved once (both directions' projections in,
// y out). At H = 32 that is ~7 flops per byte, far below the fp32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20 flops per byte), so bytes bound it; the T
// steps of one row are also a chain in series. What the design does about
// it: one warp per (row, direction), lane j owning unit j, so every row's
// recurrence stays on chip for all T steps and device memory sees each
// projection read once and y written once, both as 128-byte coalesced
// rows. Lane j keeps columns j, H + j and 2H + j of wh in registers (3H
// floats), and the warp's h lives in 128 bytes of shared memory: a step
// writes h_t there and reads it back as broadcast float4 loads, with
// __syncwarp() as the only barrier. The next step's projections are
// loaded before the current step's matrix-vector product, so their
// latency hides behind it; the series of T steps is covered by the many
// rows (warps) in flight on every SM. H up to 32, a multiple of 8 (lanes
// >= H idle); the wrapper refuses other H.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int H>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bigru_kernel(const float* __restrict__ xf, const float* __restrict__ xb,
             const float* __restrict__ whf, const float* __restrict__ bhf,
             const float* __restrict__ whb, const float* __restrict__ bhb,
             float* __restrict__ y, int rows, int T) {
  __shared__ __align__(16) float hs[kWarpsPerBlock][H];
  const int dir = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;   // whole warps only: no block barrier below
  const bool active = lane < H;
  const int j = active ? lane : 0;
  const float* x = dir ? xb : xf;
  const float* wh = dir ? whb : whf;
  const float* bh = dir ? bhb : bhf;

  float wr[H], wz[H], wn[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    wr[k] = wh[k * 3 * H + j];
    wz[k] = wh[k * 3 * H + H + j];
    wn[k] = wh[k * 3 * H + 2 * H + j];
  }
  const float br = bh[j], bz = bh[H + j], bn = bh[2 * H + j];

  const float* xrow = x + (int64_t)row * T * 3 * H;
  float* yrow = y + (int64_t)row * T * 2 * H + dir * H;
  float h = 0.f;
  if (active) hs[warp][lane] = 0.f;
  int t = dir ? T - 1 : 0;
  float xr = xrow[t * 3 * H + j], xz = xrow[t * 3 * H + H + j],
        xn = xrow[t * 3 * H + 2 * H + j];
  __syncwarp();
  for (int i = 0; i < T; ++i) {
    // next step's projections, loaded ahead of this step's product
    const int tn = dir ? t - 1 : t + 1;
    float nxr = 0.f, nxz = 0.f, nxn = 0.f;
    if (i + 1 < T) {
      const float* xt = xrow + tn * 3 * H;
      nxr = xt[j];
      nxz = xt[H + j];
      nxn = xt[2 * H + j];
    }
    float gr = 0.f, gz = 0.f, gn = 0.f;
#pragma unroll
    for (int k = 0; k < H; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(&hs[warp][k]);
      gr = fmaf(hv.x, wr[k], gr);
      gz = fmaf(hv.x, wz[k], gz);
      gn = fmaf(hv.x, wn[k], gn);
      gr = fmaf(hv.y, wr[k + 1], gr);
      gz = fmaf(hv.y, wz[k + 1], gz);
      gn = fmaf(hv.y, wn[k + 1], gn);
      gr = fmaf(hv.z, wr[k + 2], gr);
      gz = fmaf(hv.z, wz[k + 2], gz);
      gn = fmaf(hv.z, wn[k + 2], gn);
      gr = fmaf(hv.w, wr[k + 3], gr);
      gz = fmaf(hv.w, wz[k + 3], gz);
      gn = fmaf(hv.w, wn[k + 3], gn);
    }
    const float r = sigmoid(xr + (gr + br));
    const float z = sigmoid(xz + (gz + bz));
    const float n = tanhf(xn + r * (gn + bn));
    h = (1.f - z) * n + z * h;
    __syncwarp();   // every lane has read h_{t-1}
    if (active) {
      hs[warp][lane] = h;
      yrow[t * 2 * H + j] = h;
    }
    __syncwarp();   // h_t visible to the warp
    xr = nxr;
    xz = nxz;
    xn = nxn;
    t = tn;
  }
}

template <int H>
int launch(const void* xf, const void* xb, const void* whf, const void* bhf,
           const void* whb, const void* bhb, void* y, int rows, int T,
           cudaStream_t s) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock, 2);
  bigru_kernel<H><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      (const float*)xf, (const float*)xb, (const float*)whf,
      (const float*)bhf, (const float*)whb, (const float*)bhb, (float*)y,
      rows, T);
  return (int)cudaGetLastError();
}

}  // namespace

// y (rows, T, 2H) = both directions of the GRU over xproj_f / xproj_b
// (rows, T, 3H), all fp32 and contiguous; returns cudaGetLastError() after
// the launch (0 = success).
extern "C" int gru_bidir_fwd(const void* xf, const void* xb, const void* whf,
                             const void* bhf, const void* whb,
                             const void* bhb, void* y, int rows, int T,
                             int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || T < 1) return (int)cudaErrorInvalidValue;
  switch (hidden) {
    case 8:
      return launch<8>(xf, xb, whf, bhf, whb, bhb, y, rows, T, s);
    case 16:
      return launch<16>(xf, xb, whf, bhf, whb, bhb, y, rows, T, s);
    case 24:
      return launch<24>(xf, xb, whf, bhf, whb, bhb, y, rows, T, s);
    case 32:
      return launch<32>(xf, xb, whf, bhf, whb, bhb, y, rows, T, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
