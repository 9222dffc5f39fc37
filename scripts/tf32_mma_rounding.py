"""How the tensor cores round a TF32 mma's sum, measured on one NVIDIA GPU.

    python3 scripts/tf32_mma_rounding.py

Builds a one-warp kernel of a single mma.sync.aligned.m16n8k8 .tf32
(operands already TF32, so every product is exact) with nvcc into
build/tf32_mma_rounding/, runs it on 4096 random problems D = A B + C for
three sizes of the accumulator C (much larger than the products, about as
large, zero), and compares D with the exact sum rounded to fp32 to
nearest and toward zero: the share of results equal to each, and the mean
signed error in units of the last place (negative: toward zero). The fp32
attention kernels (csrc/unmasked_attention.cu, the split-TF32 sources) are
designed around the answer, and tests/torch_attention_cases.py
`tf32x3_attention_model` models it. Prints the card's name and power
limit. Needs a CUDA device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))
SOURCE = r"""
#include <stdint.h>
// one m16n8k8 TF32 mma per warp: D = A B + C; A (16x8) row-major, B[k][n]
// (8x8), C and D (16x8)
extern "C" __global__ void mma_tf32(const float* A, const float* B,
                                    const float* C, float* D, int n) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= n) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float *a = A + w * 128, *b = B + w * 64, *c = C + w * 128;
  float* d = D + w * 128;
  const uint32_t a0 = __float_as_uint(a[g * 8 + t]),
                 a1 = __float_as_uint(a[(g + 8) * 8 + t]),
                 a2 = __float_as_uint(a[g * 8 + t + 4]),
                 a3 = __float_as_uint(a[(g + 8) * 8 + t + 4]),
                 b0 = __float_as_uint(b[t * 8 + g]),
                 b1 = __float_as_uint(b[(t + 4) * 8 + g]);
  float c0 = c[g * 8 + 2 * t], c1 = c[g * 8 + 2 * t + 1],
        c2 = c[(g + 8) * 8 + 2 * t], c3 = c[(g + 8) * 8 + 2 * t + 1];
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  d[g * 8 + 2 * t] = c0;
  d[g * 8 + 2 * t + 1] = c1;
  d[(g + 8) * 8 + 2 * t] = c2;
  d[(g + 8) * 8 + 2 * t + 1] = c3;
}
extern "C" int run_mma_tf32(const float* A, const float* B, const float* C,
                            float* D, int n) {
  mma_tf32<<<(n + 3) / 4, 128>>>(A, B, C, D, n);
  return (int)cudaDeviceSynchronize();
}
"""


def tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it."""
    i = x.astype(np.float32).view(np.int32).astype(np.int64)
    return ((i + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def toward_zero(x: np.ndarray) -> np.ndarray:
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_mma_rounding: no CUDA device", file=sys.stderr)
        return 1
    from fudanocr_tpu_torch.ops import _build

    out = ROOT / "build" / "tf32_mma_rounding"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mma_tf32.cu").write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.ARCH, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(out / "mma_tf32.so"),
                    str(out / "mma_tf32.cu")], check=True)
    lib = ctypes.CDLL(str(out / "mma_tf32.so"))
    lib.run_mma_tf32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    n = 4096
    for name, c_scale in (("C ~ 1e3 (the accumulator dominates)", 1e3),
                          ("C ~ 1", 1.0), ("C = 0", 0.0)):
        a = tf32(rng.standard_normal((n, 16, 8)).astype(np.float32))
        b = tf32(rng.standard_normal((n, 8, 8)).astype(np.float32))
        c = (c_scale * rng.standard_normal((n, 16, 8))).astype(np.float32)
        ts = [torch.from_numpy(x).cuda() for x in (a, b, c)]
        d = torch.empty_like(ts[2])
        if lib.run_mma_tf32(*(t.data_ptr() for t in ts), d.data_ptr(), n):
            raise SystemExit("the mma kernel failed")
        d = d.cpu().numpy()
        exact = np.einsum("nik,nkj->nij", a.astype(np.float64),
                          b.astype(np.float64)) + c.astype(np.float64)
        rn, rz = exact.astype(np.float32), toward_zero(exact)
        ulp = np.spacing(np.abs(rn)).astype(np.float64)
        signed = np.mean((d - exact) / ulp * np.sign(exact))
        print(f"tf32 mma, {name}: equal to round-to-nearest "
              f"{(d == rn).mean():.4f}, toward zero {(d == rz).mean():.4f}, "
              f"neither {((d != rn) & (d != rz)).mean():.4f}; mean signed "
              f"error {signed:+.3f} ulp [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
