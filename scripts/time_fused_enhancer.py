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

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))   # after PYTHONPATH: another tree's package wins
SHAPES = ((64, torch.float32), (64, torch.bfloat16), (256, torch.bfloat16))
LR_HW = (16, 64)
ITERS = 20
VARIANTS = {
    "attention_only": (
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
        "constexpr int kMinBlocks = std::is_same<T, __nv_bfloat16>::value"
        " ? 2 : 1;",
        "constexpr int kMinBlocks = 1;"),
}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms_by_kernel(fn, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.device_time_total > 0:
            name = re.split(r"[<(]", re.sub(
                r"^void |\(anonymous namespace\)::", "", e.key))[0]
            split[name] = round(split.get(name, 0.0)
                                + e.device_time_total / 1e3 / iters, 4)
    return split


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


def ptxas_report() -> None:
    from fudanocr_tpu_torch.ops import _build

    src = _build.CSRC / "fused_enhancer.cu"
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-c", str(src), "-o",
                            os.path.join(tmp, "fe.o")],
                           capture_output=True, text=True, check=True)
    kernel = None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"(qkv_proj_mma_kernel|qkv_proj_kernel|"
                             r"attn_epilogue_kernel)(I\w*?Li(\d+)E)?",
                             m.group(1))
            kernel = name.group(1) + (
                f"<{'bf16' if 'bfloat16' in name.group(2) else 'fp32'}, "
                f"{name.group(3)}>" if name.group(2) else "")
        elif kernel and ("Used" in line or "spill" in line):
            print(f"ptxas: {kernel}: {line.split(' : ')[-1].strip()}")


def variants() -> int:
    out = ROOT / "build" / "enhancer_variants"
    env = dict(os.environ)
    builds = []
    for name, (old, new) in VARIANTS.items():
        tree = out / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / "fudanocr_tpu_torch",
                        tree / "fudanocr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = tree / "fudanocr_tpu_torch" / "csrc" / "fused_enhancer.cu"
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: its anchor is not in the "
                             f"source once")
        src.write_text(text.replace(old, new))
        env_v = {**env, "PYTHONPATH": str(tree)}
        builds.append(subprocess.Popen(
            [sys.executable, "-c",
             "from fudanocr_tpu_torch.ops import _build; _build.build()"],
            env=env_v))
    if any([p.wait() for p in builds]):   # wait for every build
        raise SystemExit("a variant did not build")
    order = list(VARIANTS)
    for name in order + order[::-1]:
        rc = subprocess.call(
            [sys.executable, __file__, "--as", name],
            env={**env, "PYTHONPATH": str(out / name)})
        if rc:
            return rc
    return 0


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
        ptxas_report()
    tree = Path(_build.__file__).resolve().parents[2]
    time_b1(f"tree {tree.name or tree}", SHAPES)
    return variants() if "--variants" in argv else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
