"""Time the port's fp32 segmentation attention kernels (the split-TF32
forward of B5, B6 and B7, csrc/unmasked_attention_fwd_tf32x3.cu, and the
backward of B6 and B7, csrc/unmasked_attention_bwd_tf32x3.cu, with their
helpers csrc/tf32x3.cuh) on one NVIDIA GPU, and diagnostic variants of the
sources; with `--bf16`, the bf16 kernels of csrc/unmasked_attention.cu
instead.

    python3 scripts/time_seg_attention.py              # this checkout
    python3 scripts/time_seg_attention.py --variants   # and the variants
    python3 scripts/time_seg_attention.py --variants=rows128,one_block
    python3 scripts/time_seg_attention.py --ptxas      # and the registers
    python3 scripts/time_seg_attention.py --bf16 [--ptxas]
    cd <other checkout> && PYTHONPATH=. python3 <this file>   # that one
    python3 scripts/time_seg_attention.py --bf16 \
        --turns=build/parent,.,.,build/parent

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
`--ptxas` first compiles the two split-TF32 sources (with `--bf16`,
csrc/unmasked_attention.cu) once more with the build's nvcc flags and
-Xptxas -v, and prints their kernels' registers and spills as ptxas
reports them.
`--bf16` times, at the bf16 seg steps' shapes (chip_smoke.py phase 29:
the det recipe's level 0 at batch 2, the plain recipe's stage 0 at batch
8; the det canvas's level 0 at batch 3) and on the models' layout (k and
v column slices of one (B, Lkv, 2D) projection), the inference forward
and the STATS (training) forward, unmasked and MASKED, and the backward
unmasked and MASKED, each beside SDPA's bf16 call on the same (B, H, L,
dh) views (the float mask for B6; its backward through autograd), timed
only. `--turns=a,b,...` runs it once per listed checkout (a `git archive`
of a parent under build/, `.` for this one), one process each, so that
two trees are timed in turns in one call on one card.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import os
import re
import subprocess
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
# bf16: (B, Lq, Lkv, D, heads) of the det recipe's level 0 at batch 2 (the
# step), the det canvas's at batch 3, the plain recipe's stage 0 at batch 8
BF16_SHAPES = ((2, 65536, 1024, 32, 1), (3, 65536, 1024, 32, 1),
               (8, 16384, 256, 32, 1))
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


def time_bf16(tag: str) -> None:
    """The bf16 kernels at BF16_SHAPES beside SDPA (see the top)."""
    import torch.nn.functional as F

    from fudanocr_tpu_torch.ops import region_attention as ra

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    gpu = card()
    bf = lambda *shape: torch.randn(*shape, generator=gen).to(
        dev, torch.bfloat16)
    for b, lq, lk, d, heads in BF16_SHAPES:
        # as the models give them: k and v column slices of one projection
        kv = bf(b, lk, 2 * d)
        q, k, v, do = bf(b, lq, d), kv[..., :d], kv[..., d:], bf(b, lq, d)
        rq, rkv = ids(gen, b, lq, dev), ids(gen, b, lk, dev)
        views = [t.unflatten(-1, (heads, d // heads)).transpose(1, 2)
                 for t in (q, k, v, do)]
        mask = ra.region_mask(rq, rkv)[:, None].to(torch.bfloat16)
        shape = f"({b}, {lq}, {lk}, {d}, {heads} heads) bf16"
        for masked in (False, True):
            idv = (rq, rkv) if masked else ()
            what = "region" if masked else "packed"
            am = mask if masked else None
            sdpa = lambda: F.scaled_dot_product_attention(*views[:3],
                                                          attn_mask=am)
            want = (ra.region_flash_mha_reference(q, k, v, rq, rkv, heads)
                    if masked else ra.packed_flash_mha_reference(q, k, v,
                                                                 heads))
            fwd = (lambda: ra.region_packed_fwd(q, k, v, rq, rkv, heads)) \
                if masked else (lambda: ra.unmasked_packed_fwd(q, k, v, heads))
            stats = (lambda: ra.region_packed_fwd(q, k, v, rq, rkv, heads,
                                                  stats=True)) if masked \
                else (lambda: ra.unmasked_packed_fwd(q, k, v, heads,
                                                     stats=True))
            err = (fwd() - want).abs().max().item()
            report(tag, f"{what} forward {shape}", fwd, err, gpu)
            err = (stats()[0] - want).abs().max().item()
            report(tag, f"{what} STATS forward {shape}", stats, err, gpu)
            report(tag, f"SDPA {what} forward {shape}", sdpa, 0.0, gpu)
            if b == 3:
                continue
            _, o32, m, inv = stats()
            bwd = (lambda: ra.region_packed_bwd(q, k, v, rq, rkv, o32, do, m,
                                                inv, heads)) if masked \
                else (lambda: ra.unmasked_packed_bwd(q, k, v, o32, do, m,
                                                     inv, heads))
            plain = (ra.region_flash_mha_bwd_reference(q, k, v, *idv, do,
                                                       heads) if masked
                     else ra.packed_flash_mha_bwd_reference(q, k, v, do,
                                                            heads))
            err = max(((g.float() - w.float()).norm() / w.float().norm())
                      .item() for g, w in zip(bwd(), plain))
            report(tag, f"{what} backward {shape} (err: the largest "
                   f"norm-relative)", bwd, err, gpu)
            leaves = [t.detach().clone().requires_grad_()
                      for t in views[:3]]
            so = F.scaled_dot_product_attention(*leaves, attn_mask=am)
            report(tag, f"SDPA {what} backward {shape}",
                   lambda: torch.autograd.grad(so, leaves, views[3],
                                               retain_graph=True), 0.0, gpu)
            del o32, m, inv, plain, leaves, so
        del q, k, v, kv, do, views, mask
        torch.cuda.empty_cache()


def turns(trees: list, argv: list) -> int:
    """This script with `argv` once per tree, one process each, the tree's
    package first on the import path."""
    for tree in trees:
        path = (ROOT / tree).resolve()
        print(f"== {tree}", flush=True)
        rc = subprocess.call([sys.executable, __file__, *argv],
                             cwd=path, env={**os.environ,
                                            "PYTHONPATH": str(path)})
        if rc:
            return rc
    return 0


def kernel_name(mangled: str):
    """`attn_..._{tf32x3,mma}_kernel<dh, flags...>` of a mangled name."""
    name = re.search(
        r"(attn_\w+?_(?:tf32x3|mma)_kernel)ILi(\d+)E((?:Lb[01]E)*)",
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
    chosen = [a.split("=", 1)[1] for a in argv if a.startswith("--turns=")]
    if chosen:
        return turns(chosen[0].split(","),
                     [a for a in argv if not a.startswith("--turns=")])
    from fudanocr_tpu_torch.ops import _build

    _build.build()
    bf16 = "--bf16" in argv
    if "--ptxas" in argv:
        ptxas_report(("unmasked_attention.cu",) if bf16 else SOURCES,
                     kernel_name)
    tree = Path(_build.__file__).resolve().parents[2]
    (time_bf16 if bf16 else time_kernels)(f"tree {tree.name or tree}")
    chosen = [a.split("=", 1)[1].split(",") if "=" in a else list(VARIANTS)
              for a in argv if a.startswith("--variants")]
    return (variants(__file__, "seg_attention_variants", VARIANTS,
                     chosen[0]) if chosen else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
