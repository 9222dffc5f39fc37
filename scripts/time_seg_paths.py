"""Time the segmentation slice end to end (chip_smoke.py phases 8, 9,
11-12 and 14-16: TextSeg slide and whole-image inference, the det-guided
slide and whole image, both training recipes) in one or more checkouts,
one process each, so a parent and a change can be run in turns on one
card.

    python3 scripts/time_seg_paths.py                 # this checkout
    python3 scripts/time_seg_paths.py --turns P,.,.,P,P,.

A run imports the chip_smoke.py of the checkout in the current directory
and calls its phase functions, which check every result as the full
chip_smoke.py does and print the kernel path's and the plain path's wall
per canvas or per step (CUDA events) and the device's busy time in one
profiled canvas or step. `--turns` runs this file once in each listed
checkout (a directory; `.` is this one), in the order given, prints their
lines, then for each checkout every timing line once with each number as
the median and range over its runs. Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = re.compile(r"per canvas:|train step fp32|device busy")
NUMBER = re.compile(r"\d+\.\d+")


def run_tree() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from fudanocr_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = cs.card()
    _build.build()
    _build.load_library()
    models = cs.seg_models(dev)
    cs.phase8(dev, gpu, models)
    cs.phase9(dev, gpu, models)
    del models
    torch.cuda.empty_cache()
    cs.phase11_12(dev, gpu)
    torch.cuda.empty_cache()
    for config, want in cs.TRAIN_RECIPES:
        cs.train_recipe(config, want, dev, gpu)
        torch.cuda.empty_cache()


def turns(trees: list, script: str = __file__, timing=TIMING,
          same=None, args: tuple = ()) -> int:
    """Run `script` (with `args`) in each of `trees` in order; summarise
    each tree's lines that `timing` matches. Lines that `same` matches must
    be equal in every turn: they are compared, and a difference fails."""
    runs, alike = {}, []
    for i, tree in enumerate(trees):
        path = os.path.abspath(os.path.join(ROOT, tree))
        proc = subprocess.run([sys.executable, os.path.abspath(script),
                               *args], cwd=path, capture_output=True,
                              text=True)
        print(f"turn {i} ({tree}): exit {proc.returncode}", flush=True)
        for line in proc.stdout.splitlines():
            print(f"turn {i} ({tree}): {line}")
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.setdefault(tree, []).append(   # without the card's name
            [re.sub(r" \[[^]]*\]$", "", line)
             for line in proc.stdout.splitlines() if timing.search(line)])
        if same is not None:
            alike.append([line for line in proc.stdout.splitlines()
                          if same.search(line)])
    for tree, lines in runs.items():
        for rows in zip(*lines):
            values = [[float(x) for x in NUMBER.findall(r)] for r in rows]
            parts = NUMBER.split(rows[0])
            text = parts[0]
            for col, part in zip(zip(*values), parts[1:]):
                text += (f"{statistics.median(col)} [{min(col)}, "
                         f"{max(col)}]{part}")
            print(f"median of {len(rows)} ({tree}): {text}")
    if same is not None:
        equal = all(lines == alike[0] for lines in alike)
        print(f"lines matching {same.pattern!r} equal in all "
              f"{len(alike)} turns: {equal}")
        return 0 if equal else 1
    return 0


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("time_seg_paths: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--turns"]:
        return turns(argv[1].split(","))
    run_tree()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
