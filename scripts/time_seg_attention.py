"""Time the port's fp32 segmentation attention kernels (the split-TF32
forward of B5, B6 and B7, csrc/unmasked_attention_fwd_tf32x3.cu, and the
backward of B6 and B7, csrc/unmasked_attention_bwd_tf32x3.cu, with their
helpers csrc/tf32x3.cuh) on one NVIDIA GPU, and diagnostic variants of the
sources.

    python3 scripts/time_seg_attention.py              # this checkout
    python3 scripts/time_seg_attention.py --variants   # and the variants
    python3 scripts/time_seg_attention.py --variants=rows128,one_block
    python3 scripts/time_seg_attention.py --ptxas      # and the registers
    cd <other checkout> && PYTHONPATH=. python3 <this file>   # that one

At the main paths' shapes (chip_smoke.py phases 7, 10 and 13: stage or
level 0 and 3 of 1024² crops, the 2048² whole image's stage 0 and a
512x1024 image's stage 3, the plain recipe's stage 0 at batch 8; and a
backward at dh 64, which no path runs), on standard-normal operands from a
seed, it prints per call the ms (CUDA events, the mean of two runs of
ITERS calls), the device ms by kernel (torch.profiler) and the largest
error against the plain version, with the card's name and power limit. The
package timed is the one on the import path, so the same file times a
parent checkout beside this one.

The harness is scripts/kernel_timing.py's.
`--variants` copies the package into build/seg_attention_variants/<name>/
with one edit to those sources each, builds the copies in parallel, and
times each in the order listed and then reversed (`--variants=a,b` only
those):
  one_block   no minimum of 2 blocks an SM in __launch_bounds__ at dh 32,
              so ptxas takes the registers it wants (1 block an SM);
  rows128     the forward always takes 128-row q tiles (8 warps), also
              where the grid is small;
  ldmatrix_k  the B fragments of Q K^T and dO V^T (rows g, features t
              and t + 4, hi and lo) by one ldmatrix.x4 each instead of
              four 32-bit loads.
`--ptxas` first compiles the two split-TF32 sources once more with the
build's nvcc flags and -Xptxas -v, and prints their kernels' registers
and spills as ptxas reports them.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

from kernel_timing import (ROOT, card, cuda_ms, device_ms_by_kernel,
                           ptxas_report, variants)

sys.path.append(str(ROOT))   # after PYTHONPATH: another tree's package wins
ITERS = 10
# forward: (route, B, Lq, Lkv, D, heads); route "packed" (B7), "region"
# (B6), "stats" (B7's training forward) or "bhld" (B5, D = dh, `heads`
# heads)
FWD = (("packed", 3, 65536, 1024, 32, 1), ("packed", 3, 1024, 1024, 256, 8),
       ("region", 3, 65536, 1024, 32, 1), ("region", 3, 1024, 1024, 256, 8),
       ("stats", 2, 65536, 1024, 32, 1),
       ("bhld", 1, 262144, 4096, 32, 1), ("bhld", 1, 512, 512, 32, 8))
# backward: (masked, B, Lq, Lkv, D, heads)
BWD = ((False, 2, 65536, 1024, 32, 1), (True, 2, 65536, 1024, 32, 1),
       (False, 2, 1024, 1024, 256, 8), (True, 2, 1024, 1024, 256, 8),
       (False, 8, 16384, 256, 32, 1),
       (False, 2, 16384, 1024, 64, 1))   # dh 64, off every path
SOURCES = ("unmasked_attention_fwd_tf32x3.cu",
           "unmasked_attention_bwd_tf32x3.cu")
# name: (source, its text, the variant's text)
VARIANTS = {
    "one_block": ("tf32x3.cuh", "constexpr int kTf32Blocks32 = 2;",
                  "constexpr int kTf32Blocks32 = 1;"),
    "rows128": (SOURCES[0], "constexpr int kSmallGrid = 2 * 132;",
                "constexpr int kSmallGrid = 0;"),
    "ldmatrix_k": ("tf32x3.cuh",
        """      const int off = (n * 8 + g) * P + kk * 8 + t;
      hb[n][kk][0] = ldb(bh + off);
      hb[n][kk][1] = ldb(bh + off + 4);
      mma_tf32(c[n], a.l[kk], hb[n][kk][0], hb[n][kk][1]);
      mma_tf32(c[n], a.h[kk], ldb(bl + off), ldb(bl + off + 4));
""",
        """      const int lane = threadIdx.x & 31, i = lane >> 3;
      const float* row = (i < 2 ? bh : bl) + (n * 8 + (lane & 7)) * P +
                         kk * 8 + 4 * (i & 1);
      uint32_t r[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
          : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
          : "r"((uint32_t)__cvta_generic_to_shared(row)));
      hb[n][kk][0] = r[0];
      hb[n][kk][1] = r[1];
      mma_tf32(c[n], a.l[kk], r[0], r[1]);
      mma_tf32(c[n], a.h[kk], r[2], r[3]);
"""),
}


def report(tag: str, what: str, fn, err: float, gpu: str) -> None:
    ms = [round(cuda_ms(fn, ITERS), 4) for _ in range(2)]
    split = device_ms_by_kernel(fn, ITERS)
    print(f"{tag}: {what}: ms {ms}, device ms by kernel {split}, max abs "
          f"err {err:.3e} [{gpu}]", flush=True)


def ids(gen, b: int, n: int, dev) -> torch.Tensor:
    return (torch.randint(0, 3, (b, n), generator=gen).float() / 2).to(dev)


def time_kernels(tag: str) -> None:
    from fudanocr_tpu_torch.ops import flash_attention as fa
    from fudanocr_tpu_torch.ops import region_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    gpu = card()
    rn = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    for route, b, lq, lk, d, heads in FWD:
        if route == "bhld":
            q, k, v = rn(b, heads, lq, d), rn(b, heads, lk, d), \
                rn(b, heads, lk, d)
            fn = lambda: fa.flash_mha(q, k, v)
            want = fa.flash_mha_reference(q, k, v)
        else:
            q, k, v = rn(b, lq, d), rn(b, lk, d), rn(b, lk, d)
            rq, rkv = ids(gen, b, lq, dev), ids(gen, b, lk, dev)
            fn = {"packed": lambda: ra.unmasked_packed_fwd(q, k, v, heads),
                  "region": lambda: ra.region_packed_fwd(q, k, v, rq, rkv,
                                                         heads),
                  "stats": lambda: ra.unmasked_packed_fwd(
                      q, k, v, heads, stats=True)}[route]
            want = (ra.region_flash_mha_reference(q, k, v, rq, rkv, heads)
                    if route == "region" else
                    ra.packed_flash_mha_reference(q, k, v, heads))
        got = fn()
        got = got[0] if isinstance(got, tuple) else got
        err = (got - want).abs().max().item()
        report(tag, f"{route} forward ({b}, {lq}, {lk}, {d}, {heads} heads) "
               f"fp32", fn, err, gpu)
        del q, k, v, got, want
    for masked, b, lq, lk, d, heads in BWD:
        q, k, v, do = rn(b, lq, d), rn(b, lk, d), rn(b, lk, d), rn(b, lq, d)
        rq, rkv = ids(gen, b, lq, dev), ids(gen, b, lk, dev)
        idv = (rq, rkv) if masked else ()
        if masked:
            _, o32, m, inv = ra.region_packed_fwd(q, k, v, rq, rkv, heads,
                                                  stats=True)
            fn = lambda: ra.region_packed_bwd(q, k, v, rq, rkv, o32, do, m,
                                              inv, heads)
            want = ra.region_flash_mha_bwd_reference(q, k, v, *idv, do,
                                                     heads)
        else:
            _, o32, m, inv = ra.unmasked_packed_fwd(q, k, v, heads,
                                                    stats=True)
            fn = lambda: ra.unmasked_packed_bwd(q, k, v, o32, do, m, inv,
                                                heads)
            want = ra.packed_flash_mha_bwd_reference(q, k, v, do, heads)
        err = max((g - w).abs().max().item() for g, w in zip(fn(), want))
        report(tag, f"{'region' if masked else 'packed'} backward ({b}, "
               f"{lq}, {lk}, {d}, {heads} heads) fp32", fn, err, gpu)
        del q, k, v, do, o32, want
        torch.cuda.empty_cache()


def kernel_name(mangled: str):
    """`attn_..._tf32x3_kernel<dh, masked[, stats]>` of a mangled name."""
    name = re.search(r"(attn_\w+?_tf32x3_kernel)ILi(\d+)E((?:Lb[01]E)*)",
                     mangled)
    if not name:
        return None
    flags = "".join(f", {('false', 'true')[int(f)]}"
                    for f in re.findall(r"Lb([01])E", name.group(3)))
    return f"{name.group(1)}<{name.group(2)}{flags}>"


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("time_seg_attention: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--as"]:     # one variant, from its own copy
        time_kernels(argv[1])
        return 0
    from fudanocr_tpu_torch.ops import _build

    _build.build()
    if "--ptxas" in argv:
        ptxas_report(SOURCES, kernel_name)
    tree = Path(_build.__file__).resolve().parents[2]
    time_kernels(f"tree {tree.name or tree}")
    chosen = [a.split("=", 1)[1].split(",") if "=" in a else list(VARIANTS)
              for a in argv if a.startswith("--variants")]
    return (variants(__file__, "seg_attention_variants", VARIANTS,
                     chosen[0]) if chosen else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
