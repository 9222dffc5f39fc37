// Fused residual add + reference LayerNorm, forward, hand-written for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel fudanocr_tpu/ops/fused_layernorm.py:53
// `_fwd_impl` (pallas_call at :69, body `_ln_kernel`), reached through
// `fused_residual_layernorm` (:91). The Python wrapper, the closed-form
// backward and the plain PyTorch version live in
// fudanocr_tpu_torch/ops/fused_layernorm.py.
//
// Per row of D features:
//   v = x + res                                   (fp32)
//   y = (v - mean) / (sqrt(sum((v - mean)^2) / (D - 1)) + eps) * g + b
// stored at the input type (fp32 or bf16); g and b are fp32.
//
// What bounds it on this card: ~10 flops per element against 3 elements of
// device-memory traffic (x, res in; y out), far below the ~295 flop/byte
// ridge, so it is bound by bytes. What the design does about it: one warp
// per row, the row held in registers (lane i keeps elements i, i+32, ...),
// so x and res are read exactly once, coalesced, and y written once; the
// two statistics are warp-shuffle reductions, with the variance taken
// around the mean (two passes over the registers, none over memory).
// D up to 2048 (64 values per lane); the TBSRN enhancer runs D = 128 over
// B*L rows, the text-focus oracle D = 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float ln_load(const float* p) { return *p; }
__device__ __forceinline__ float ln_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void ln_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void ln_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VPT values per lane: rows of up to 32 * VPT features.
template <typename T, int VPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_residual_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  const T* rr = res + row * d;
  T* yr = out + row * d;

  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? ln_load(xr + c) + ln_load(rr + c) : 0.f;
    sum += v[i];
  }
  const float mean = warp_sum(sum) / (float)d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    const float dv = c < d ? v[i] - mean : 0.f;
    sq += dv * dv;
  }
  const float var = warp_sum(sq) / (float)(d > 1 ? d - 1 : 1);
  const float denom = sqrtf(var) + eps;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) ln_store(yr + c, (v[i] - mean) / denom * scale[c] + bias[c]);
  }
}

template <typename T, int VPT>
int launch(const void* x, const void* res, const void* scale,
           const void* bias, void* out, int64_t rows, int d, float eps,
           cudaStream_t s) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ln_residual_kernel<T, VPT><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
      (const T*)x, (const T*)res, (const float*)scale, (const float*)bias,
      (T*)out, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* res, const void* scale,
             const void* bias, void* out, int64_t rows, int d, float eps,
             cudaStream_t s) {
  if (d <= 32) return launch<T, 1>(x, res, scale, bias, out, rows, d, eps, s);
  if (d <= 64) return launch<T, 2>(x, res, scale, bias, out, rows, d, eps, s);
  if (d <= 128) return launch<T, 4>(x, res, scale, bias, out, rows, d, eps, s);
  if (d <= 256) return launch<T, 8>(x, res, scale, bias, out, rows, d, eps, s);
  if (d <= 512)
    return launch<T, 16>(x, res, scale, bias, out, rows, d, eps, s);
  if (d <= 1024)
    return launch<T, 32>(x, res, scale, bias, out, rows, d, eps, s);
  if (d <= 2048)
    return launch<T, 64>(x, res, scale, bias, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y = LN(x + res) over `rows` rows of `d` features; returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int ln_residual_fwd(const void* x, const void* res,
                               const void* scale, const void* bias, void* out,
                               long long rows, int d, float eps, int bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch<__nv_bfloat16>(x, res, scale, bias, out, rows, d,
                                        eps, s)
              : dispatch<float>(x, res, scale, bias, out, rows, d, eps, s);
}
