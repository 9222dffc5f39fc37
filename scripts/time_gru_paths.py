"""Time TSRN's bidirectional GRU (B8) and TSRN pixels -> strings
(chip_smoke.py phase 20) in one or more checkouts, one process each, so a
parent and a change can be run in turns on one card.

    python3 scripts/time_gru_paths.py                  # this checkout
    python3 scripts/time_gru_paths.py --turns P,.,.,P
    python3 scripts/time_gru_paths.py --ptxas          # registers
    python3 scripts/time_gru_paths.py --kernels [--variants[=a,b]]

A run imports the package and the chip_smoke.py of the checkout in the
current directory. It times one call of `BiGRU(64, 32, fuse=True)` (the
module TSRN calls, whatever route the checkout gives it) on x of TSRN's
two shapes, (16384, 16, 64) and (4096, 64, 64), in fp32 and in bf16:
CUDA-event ms and device ms, and the device ms by kernel on a line of its
own. Then it runs the checkout's phase 20 on phase 2's CRNN(37, 256) in
bf16 and an LR batch made here (as `chip_smoke.phase20_alone` makes
them, so that a checkout without that function runs too): TSRN pixels ->
strings at batch 256 bf16 with its checks, img/s of the kernel, cuDNN-GRU
and plain paths.
`--turns` runs this file in each listed checkout (a directory; `.` is
this one) in the order given, as scripts/time_seg_paths.py does, and
prints every timing line's median and range per checkout. `--ptxas`
compiles csrc/fused_gru.cu once more with -Xptxas -v and prints each
kernel's registers and spills. `--kernels` times the kernel alone, both
entries at both shapes (the x-level one on fp32 and bf16 x): ms, device
ms and the largest error from the plain version; `--variants` the same
in copies of the package built with one edit each (VARIANTS; scripts/
kernel_timing.py `variants`). Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from kernel_timing import (card, cuda_ms, device_ms_by_kernel,  # noqa: E402
                           ptxas_report, variants)
from time_seg_paths import turns  # noqa: E402

TIMING = re.compile(r"BiGRU call .*: |TSRN pixels->strings")
SHAPES = ((16384, 16), (4096, 64))   # TSRN's GRUs at batch 256, 16x64 LR
C, H, ITERS = 64, 32, 20
# name: (source, its text, the variant's text): the gates on the accurate
# expf, tanhf and division, as the plain version computes them; the TF32
# split by cvt.rna (csrc/tf32x3.cuh `tf32`) in place of two integer
# operations; and a diagnostic that changes the function: the gates
# replaced by one FFMA an element (what the products and loads cost)
_GATES = """  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_gate(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));"""
_GATE_MATH = """        const float r = sigmoid(x3[0] + g3[0]);
        const float z = sigmoid(x3[1] + g3[1]);
        const float nn = tanh_gate(x3[2] + r * g3[2]);"""
VARIANTS = {
    "accurate_gates": ("fused_gru.cu", _GATES, """  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float tanh_gate(float x) {
  return tanhf(x);"""),
    "cvt_split": ("fused_gru.cu",
                  "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                  "  return tf32(x);"),
    "no_gates": ("fused_gru.cu", _GATE_MATH, """        const float r = 0.5f, z = 0.25f;
        const float nn = fmaf(x3[2], g3[2], x3[0] + g3[0] + x3[1] + g3[1]);"""),
}


def run_tree() -> None:
    import chip_smoke as cs
    from fudanocr_tpu_torch.models.rec.crnn import CRNN
    from fudanocr_tpu_torch.nn.recurrent import BiGRU
    from fudanocr_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = card()
    _build.build()
    _build.load_library()
    gen = torch.Generator().manual_seed(14)
    gru = BiGRU(C, H, fuse=True).to(dev)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * H ** -0.5)
        for rows, t in SHAPES:
            x32 = torch.randn(rows, t, C, generator=gen).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                fn = lambda: gru(x)  # noqa: E731
                ms = cuda_ms(fn, ITERS)
                split = device_ms_by_kernel(fn, ITERS)
                print(f"BiGRU call ({rows}, {t}, C {C}, H {H}) {dt}: "
                      f"{ms:.4f} ms, device {sum(split.values()):.4f} ms "
                      f"[{gpu}]", flush=True)
                print(f"BiGRU device ms by kernel ({rows}, {t}) {dt}: "
                      f"{split}", flush=True)
    del gru, x32, x
    torch.cuda.empty_cache()
    torch.manual_seed(cs.SEED)
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    crnn = CRNN(num_classes=37, hidden=256, dtype=torch.bfloat16)
    cs.randomize_stats(crnn, gen)
    lr = torch.rand(cs.BATCH, *cs.LR_HW, 3, generator=gen).to(dev)
    cs.phase20(dev, gpu, crnn.to(dev).eval(), lr)


def time_kernels(tag: str) -> None:
    """Both entries of B8 alone at TSRN's shapes: ms, device ms, and the
    largest error from the plain version (fp32 output)."""
    sys.path.append(ROOT)   # chip_smoke.py, behind a variant's package
    from chip_smoke import gru_params
    from fudanocr_tpu_torch.ops import fused_gru as fg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    gpu = card()
    for rows, t in SHAPES:
        x32 = torch.randn(rows, t, C, generator=gen).to(dev)
        params = gru_params(gen, C, H, dev)
        xp = [torch.randn(rows, t, 3 * H, generator=gen).to(dev)
              for _ in range(2)]
        jax_order = (xp[0], xp[1], params[2].t().contiguous(), params[3],
                     params[6].t().contiguous(), params[7], H)
        cases = [("projections in, fp32", lambda: fg.fused_bigru(*jax_order),
                  lambda: fg.fused_bigru_reference(*jax_order))]
        for dt in (torch.float32, torch.bfloat16):
            args = (x32.to(dt), *params, H)
            cases.append((f"x {dt}",
                          lambda a=args: fg.fused_bigru_x(*a),
                          lambda a=args: fg.fused_bigru_x_reference(
                              *a, out_dtype=torch.float32)))
        for what, fn, ref in cases:
            out = fn()
            err = (out.float() - ref()).abs().max().item() \
                if out.dtype == torch.float32 else float("nan")
            ms = [round(cuda_ms(fn, ITERS), 4) for _ in range(2)]
            dms = sum(device_ms_by_kernel(fn, ITERS).values())
            print(f"{tag}: B8 ({rows}, {t}) {what}: ms {ms}, device "
                  f"{dms:.4f} ms, max abs err {err:.3e} [{gpu}]", flush=True)


def kernel_name(mangled: str):
    """`bigru_tf32x3_kernel<H>` (or the parent's `bigru_kernel<H>`) of a
    mangled name, with the input type and the projection flag."""
    m = re.search(r"(bigru_\w*kernel)ILi(\d+)E(\w*)", mangled)
    return f"{m.group(1)}<{m.group(2)}{m.group(3)[:24]}>" if m else None


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("time_gru_paths: no CUDA device", file=sys.stderr)
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
        ptxas_report(("fused_gru.cu",), kernel_name)
    if "--kernels" in argv:
        time_kernels(f"tree {os.path.basename(os.getcwd())}")
    chosen = [a.split("=", 1)[1].split(",") if "=" in a else list(VARIANTS)
              for a in argv if a.startswith("--variants")]
    return (variants(__file__, "gru_variants", VARIANTS, chosen[0])
            if chosen else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
