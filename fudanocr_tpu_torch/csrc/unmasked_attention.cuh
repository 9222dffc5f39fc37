// Shared by the segmentation attention sources: csrc/unmasked_attention.cu
// (the C entries, the bf16 kernels, and the design of the whole family at
// its top) and the split-TF32 fp32 kernels,
// csrc/unmasked_attention_fwd_tf32x3.cu and _bwd_tf32x3.cu: the tile
// sizes, the operands' strides and the launch arguments, and the fp32
// launchers that the C entries call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seg_attn {

constexpr int kRows = 128;   // q rows (or keys) per block
constexpr int kTile = 64;    // rows per K/V (or Q/dO) tile in shared memory
constexpr float kNeg = -1e10f;   // the reference's suppression constant
constexpr int kMmaWarps = kRows / 16;        // 16 rows per warp
constexpr int kMmaThreads = 32 * kMmaWarps;

struct Strides {   // element strides of one operand
  int64_t b, h, r;
};

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  const float *rq, *rkv;
  float *stat_m, *stat_inv;
  int Lq, Lkv;
  Strides sq, sk, sv, so;
  float scale;
  float* o32;   // bf16 STATS: the fp32 product with fp32 probabilities
};

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *o, *rq, *rkv, *stat_m, *stat_inv;
  float *delta, *dk_part, *dv_part;
  void *dq, *dk, *dv;
  int B, H, Lq, Lkv, q_chunk;
  Strides sq, sk, sv;
  float scale;
};

// The fp32 forward (rq == nullptr: unmasked; stats: the training forward)
// on the grid (Lq / kRows, H, B); returns cudaGetLastError() after the
// launch.
int launch_fwd_tf32x3(const FwdArgs& a, int dh, bool stats, dim3 grid,
                      cudaStream_t s);
// Launches 1 and 2 of the fp32 backward (dQ and D; the dK/dV partials of
// `splits` q slices); returns cudaGetLastError() after them.
int launch_bwd_tf32x3(const BwdArgs& a, int dh, int splits, cudaStream_t s);

}  // namespace seg_attn
