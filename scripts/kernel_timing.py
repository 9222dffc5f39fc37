"""The harness that the kernel timing scripts (scripts/time_*.py) share:
the card's name and power limit, CUDA-event and profiler times, ptxas's
register report of a source, and variants of the sources built and timed
in copies of the package. Each script keeps its shapes, its variants'
edits and its kernels' names.

A variant is (source in fudanocr_tpu_torch/csrc/, the text it holds once,
the text that replaces it), or a list of such edits. `variants` copies the
package into build/<out>/<name>/ with its edits, builds the copies in
parallel, then runs `<script> --as <name>` from each copy, in the order
given and then reversed.
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


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of `fn` over `iters` calls, CUDA events, after one
    warm-up call."""
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
    """Device ms per call of `fn` by kernel name (torch.profiler, `iters`
    calls after a warm-up call)."""
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


def ptxas_report(sources, kernel_name) -> None:
    """Compile each of `sources` (files of the package's csrc/) once more
    with the build's nvcc flags and -Xptxas -v, and print each kernel's
    registers, spills and static shared memory as ptxas reports them,
    under `kernel_name(mangled name)` (kernels it maps to None are left
    out)."""
    from fudanocr_tpu_torch.ops import _build

    out = ""
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                                "-Xptxas", "-v", "-c", str(_build.CSRC / src),
                                "-o", os.path.join(tmp, "k.o")],
                               capture_output=True, text=True, check=True)
            out += r.stdout + r.stderr
    kernel = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif kernel and ("Used" in line or "spill" in line):
            print(f"ptxas: {kernel}: {line.split(' : ')[-1].strip()}")


def variants(script: str, out: str, edits: dict, names: list) -> int:
    """Build the variants `names` of `edits` (name: (source, text, new
    text)) in copies of the package under build/<out>/, then time each
    with `script --as <name>` in the order given and then reversed;
    returns the first non-zero exit code, else 0."""
    base = ROOT / "build" / out
    env = dict(os.environ)
    builds = []
    for name in names:
        tree = base / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / "fudanocr_tpu_torch",
                        tree / "fudanocr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        edit = edits[name]
        for path, old, new in (edit if isinstance(edit, list) else [edit]):
            src = tree / "fudanocr_tpu_torch" / "csrc" / path
            text = src.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: its anchor is not in the "
                                 f"source once")
            src.write_text(text.replace(old, new))
        builds.append(subprocess.Popen(
            [sys.executable, "-c",
             "from fudanocr_tpu_torch.ops import _build; _build.build()"],
            env={**env, "PYTHONPATH": str(tree)}))
    if any([p.wait() for p in builds]):   # wait for every build
        raise SystemExit("a variant did not build")
    for name in names + names[::-1]:
        rc = subprocess.call([sys.executable, script, "--as", name],
                             env={**env, "PYTHONPATH": str(base / name)})
        if rc:
            return rc
    return 0
