// Shared by the hash-dropout attention sources: csrc/
// flash_attention_dropout.cu (the C entries, the bf16 tensor-core kernels
// and the design of the whole family at its top) and the fp32 split-TF32
// kernels, csrc/flash_attention_dropout_tf32x3.cu: the keep hash, the
// operands' base pointers and row strides, and the fp32 launchers that the
// C entries call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dropout_attn {

// murmur3 fmix32 (fudanocr_tpu/ops/flash_attention.py:256 `_fmix`)
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// per-(image, head) seed (flash_attention.py:266 `_bh_seed`)
__device__ __forceinline__ uint32_t bh_seed(uint32_t seed, uint32_t b,
                                            uint32_t h, uint32_t heads) {
  return fmix32(seed ^ ((b * heads + h) * 0x9E3779B9u));
}

// An operand's base pointer and row stride (elements); an image's rows
// follow one another (batch stride L * row).
struct Operand {
  const void* p;
  int64_t row;
};

// A gradient's base pointer and row stride, as Operand.
struct Grad {
  void* p;
  int64_t row;
};

// What every launch of the fp32 kernels takes: q, k, v, the device seed,
// the shape (dh = 32), scale = 1/sqrt(dh), inv_keep = 1/(1 - rate), the
// keep threshold and b0, the global index of image 0 (a data-parallel
// rank's first row; the hash keys image b on b0 + b).
struct Args {
  Operand q, k, v;
  const int64_t* seed;
  int B, L, H;
  float scale, inv_keep;
  uint32_t thresh, b0;
};

// The fp32 forward: out (B, L, H*32) contiguous and lse (B, H, L);
// returns cudaGetLastError() after the launch.
int launch_fwd_tf32x3(const Args& a, float* out, float* lse,
                      cudaStream_t s);
// The fp32 backward, two launches (dQ and D into delta (B, H, L); dK and
// dV); out and dout (B, L, H*32) contiguous; returns cudaGetLastError()
// after them.
int launch_bwd_tf32x3(const Args& a, const float* out, const float* dout,
                      const float* lse, float* delta, Grad dq, Grad dk,
                      Grad dv, cudaStream_t s);

}  // namespace dropout_attn
