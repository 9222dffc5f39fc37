"""Time the port's fused-enhancer kernel (B1, csrc/fused_enhancer.cu) on
one NVIDIA GPU, and diagnostic variants of its source.

    python3 scripts/time_fused_enhancer.py              # this checkout
    python3 scripts/time_fused_enhancer.py --variants   # and the variants
    python3 scripts/time_fused_enhancer.py --ptxas      # and the registers
    cd <other checkout> && PYTHONPATH=. python3 <this file>   # that one

For (64, 1024) fp32 and bf16 and (256, 1024) bf16 tokens (chip_smoke.py
phase 1's shapes and weights' scales, from a seed) it prints the ms per
call (CUDA events, three means of 20 calls), the device ms per call by
kernel (torch.profiler) and the error against the plain version, with the
card's name and power limit. The package timed is the one on the import
path, so the same file times a parent checkout beside this one.

The harness is scripts/kernel_timing.py's.
`--variants` copies the package into build/enhancer_variants/<name>/ with
one edit to csrc/fused_enhancer.cu each, builds the copies in parallel,
and times B1 at (256, 1024) bf16 in each, in the order listed and then
reversed:
  attention_only   the bf16 kernel returns after the attention (its
                   output is wrong: a timing of the attention part alone);
  no_register_cap  no minimum of 2 blocks an SM in __launch_bounds__, so
                   ptxas takes the registers it wants (1 block an SM).
`--ptxas` first compiles csrc/fused_enhancer.cu once more with the
build's nvcc flags and -Xptxas -v, and prints each kernel's registers,
spills and static shared memory as ptxas reports them.
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
SHAPES = ((64, torch.float32), (64, torch.bfloat16), (256, torch.bfloat16))
LR_HW = (16, 64)
ITERS = 20
SOURCE = "fused_enhancer.cu"
VARIANTS = {
    "attention_only": (
        SOURCE,
        "    attention_mma<DH>(qkv, img, q0, L, sm, wout, ws, bufA);\n",
        "    attention_mma<DH>(qkv, img, q0, L, sm, wout, ws, bufA);\n"
        "    if (L > 0) {\n"
        "      cp_async_wait<0>();\n"
        "      __syncthreads();\n"
        "      if (threadIdx.x < kC) out[(img + q0) * kC + threadIdx.x] =\n"
        "          bufA[threadIdx.x];\n"
        "      return;\n"
        "    }\n"),
    "no_register_cap": (
        SOURCE,
        "constexpr int kMinBlocks = std::is_same<T, __nv_bfloat16>::value"
        " ? 2 : 1;",
        "constexpr int kMinBlocks = 1;"),
}


def time_b1(tag: str, shapes) -> None:
    from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
    from fudanocr_tpu_torch.ops.fused_enhancer import (
        enhancer_operands, fused_enhancer, fused_enhancer_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    d = 128

    def rn(*shape, s):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    params = {"wqkv": rn(d, 3 * d, s=d ** -0.5), "bqkv": rn(3 * d, s=0.1),
              "wout": rn(d, d, s=d ** -0.5), "bout": rn(d, s=0.1),
              "ln1_scale": 1 + rn(d, s=0.2), "ln1_bias": rn(d, s=0.1),
              "w1": rn(d, d, s=d ** -0.5), "b1": rn(d, s=0.1),
              "w2": rn(d, d, s=d ** -0.5), "b2": rn(d, s=0.1),
              "ln2_scale": 1 + rn(d, s=0.2), "ln2_bias": rn(d, s=0.1),
              "wp": rn(d, 64, s=d ** -0.5), "bp": rn(64, s=0.1)}
    h, w = LR_HW
    pe = torch.from_numpy(positional_encoding_2d(64, h, w).reshape(
        64, h * w).T.copy()).to(dev)
    gpu = card()
    for b, dt in shapes:
        ops = enhancer_operands(params, pe, dt)
        x = (torch.randn(b, h * w, 64, generator=gen) * 0.5).to(dev, dt)
        err = (fused_enhancer(x, ops).float()
               - fused_enhancer_reference(x, ops).float()).abs()
        ms = [round(cuda_ms(lambda: fused_enhancer(x, ops), ITERS), 4)
              for _ in range(3)]
        split = device_ms_by_kernel(lambda: fused_enhancer(x, ops), ITERS)
        print(f"{tag}: B1 ({b}, {h * w}) {dt}: ms {ms}, device ms by kernel "
              f"{split}, max abs err {err.max().item():.3e}, mean "
              f"{err.mean().item():.3e} [{gpu}]", flush=True)


def kernel_name(mangled: str) -> str:
    """`kernel<fp32|bf16, dh>` (or the bare name) of a mangled name."""
    name = re.search(r"(qkv_proj_mma_kernel|qkv_proj_kernel|"
                     r"attn_epilogue_kernel)(I\w*?Li(\d+)E)?", mangled)
    return name.group(1) + (
        f"<{'bf16' if 'bfloat16' in name.group(2) else 'fp32'}, "
        f"{name.group(3)}>" if name.group(2) else "")


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("time_fused_enhancer: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--as"]:     # one variant, from its own copy
        time_b1(argv[1], SHAPES[2:])
        return 0
    from fudanocr_tpu_torch.ops import _build

    _build.build()
    if "--ptxas" in argv:
        ptxas_report((SOURCE,), kernel_name)
    tree = Path(_build.__file__).resolve().parents[2]
    time_b1(f"tree {tree.name or tree}", SHAPES)
    return (variants(__file__, "enhancer_variants", VARIANTS,
                     list(VARIANTS)) if "--variants" in argv else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
