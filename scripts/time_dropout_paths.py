"""Time the hash-dropout attention kernels and the fp32 TBSRN text-focus
train step (chip_smoke.py phases 5, 6 and 24: B4 at (64, 1024, 384) fp32
and bf16 and at (128, 1024, 384) bf16, the SRTrainer step at batch 64
fp32, B10 and B11 at (64, 1024, 128)) in one or more checkouts, one
process each, so a parent and a change can be run in turns on one card.

    python3 scripts/time_dropout_paths.py                  # this checkout
    python3 scripts/time_dropout_paths.py --turns P,.,.,P
    python3 scripts/time_dropout_paths.py --ptxas          # registers
    python3 scripts/time_dropout_paths.py --kernels [--variants[=a,b]]

A run imports the chip_smoke.py of the checkout in the current directory
and calls its phase functions, which check every result as the full
chip_smoke.py does (the kernels by name, the bars, the launches per step)
and print the kernels' and the plain versions' ms, SDPA's (timed only)
and the bound, and the train step's ms and img/s on the kernel path and
the plain path. `--turns` runs this file in each listed checkout (a
directory; `.` is this one) in the order given, as
scripts/time_seg_paths.py does, and prints every timing line's median and
range per checkout. `--ptxas` compiles the dropout sources once more with
-Xptxas -v and prints each kernel's registers and spills. `--kernels`
times the fp32 kernels of B4 alone at (64, 1024, 384) (ms, and device ms
by kernel), and `--variants` the same in copies of the package built with
one edit each (VARIANTS; scripts/kernel_timing.py `variants`). Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from kernel_timing import (card, cuda_ms, device_ms_by_kernel,  # noqa: E402
                           ptxas_report, variants)
from time_seg_paths import turns  # noqa: E402

TIMING = re.compile(r"forward kernel|train step at batch")
SOURCES = ("flash_attention_dropout.cu", "flash_attention_dropout_tf32x3.cu")
B, L, HEADS, RATE, ITERS = 64, 1024, 4, 0.1, 10
# name: (source, its text, the variant's text): no register cap (one block
# an SM) on every fp32 kernel, or on the dK/dV launch only
_DKV = "\nattn_dropout_bwd_dkv_tf32x3_kernel(Operand"
VARIANTS = {
    "one_block": ("tf32x3.cuh", "constexpr int kTf32Blocks32 = 2;",
                  "constexpr int kTf32Blocks32 = 1;"),
    "dkv_one_block": (SOURCES[1], "(kMmaThreads, kTf32Blocks32)" + _DKV,
                      "(kMmaThreads, 1)" + _DKV),
}


def run_tree() -> None:
    import chip_smoke as cs
    from fudanocr_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = cs.card()
    _build.build()
    _build.load_library()
    for phase in (cs.phase5, cs.phase6, cs.phase24):
        phase(dev, gpu)
        torch.cuda.empty_cache()


def time_kernels(tag: str) -> None:
    """The fp32 forward and backward kernels of B4 at (B, L, 3 * HEADS * 32):
    ms, device ms by kernel, and the largest error from the plain
    version."""
    from fudanocr_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    gpu = card()
    qkv = torch.randn(B, L, 3 * HEADS * 32, generator=gen).to(dev)
    do = torch.randn(B, L, HEADS * 32, generator=gen).to(dev)
    seed = torch.tensor(5, device=dev)
    o, lse = fa.qkv_dropout_fwd(qkv, seed, HEADS, RATE)
    x = qkv.clone().requires_grad_()
    want = fa.flash_mha_qkv_packed_dropout_reference(x, seed, HEADS, RATE)
    (want_g,) = torch.autograd.grad(want, x, do)
    got_g = fa.qkv_dropout_bwd(qkv, o, do, lse, seed, HEADS, RATE)
    for what, fn, err in (
            ("forward", lambda: fa.qkv_dropout_fwd(qkv, seed, HEADS, RATE),
             (o - want).abs().max().item()),
            ("backward", lambda: fa.qkv_dropout_bwd(qkv, o, do, lse, seed,
                                                    HEADS, RATE),
             (got_g - want_g).abs().max().item())):
        ms = [round(cuda_ms(fn, ITERS), 4) for _ in range(2)]
        print(f"{tag}: B4 fp32 {what} ({B}, {L}, {3 * HEADS * 32}): ms {ms}, "
              f"device ms by kernel {device_ms_by_kernel(fn, ITERS)}, max "
              f"abs err {err:.3e} [{gpu}]", flush=True)


def kernel_name(mangled: str):
    """`attn_dropout_..._kernel[<VEC16>]` of a mangled name."""
    name = re.search(r"(attn_dropout_\w+?_kernel)(?:ILb([01])E)?", mangled)
    if not name:
        return None
    return name.group(1) + (f"<{('false', 'true')[int(name.group(2))]}>"
                            if name.group(2) else "")


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("time_dropout_paths: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--as"]:     # one variant, from its own copy
        time_kernels(argv[1])
        return 0
    sys.path.insert(0, os.getcwd())   # the checkout to time
    if argv[:1] == ["--turns"]:
        return turns(argv[1].split(","), __file__, TIMING)
    if not argv:
        run_tree()
        return 0
    from fudanocr_tpu_torch.ops import _build

    _build.build()
    if "--ptxas" in argv:
        ptxas_report(SOURCES, kernel_name)
    if "--kernels" in argv:
        time_kernels(f"tree {os.path.basename(os.getcwd())}")
    chosen = [a.split("=", 1)[1].split(",") if "=" in a else list(VARIANTS)
              for a in argv if a.startswith("--variants")]
    return (variants(__file__, "dropout_variants", VARIANTS, chosen[0])
            if chosen else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
