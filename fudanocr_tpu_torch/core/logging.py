"""Observability: scalar and image logging and experiment bookkeeping
(port of fudanocr_tpu/core/logging.py).

`MetricsLogger` writes JSONL lines to <log_dir>/metrics.jsonl (always) and
TensorBoard events where `torch.utils.tensorboard` imports (it needs the
`tensorboard` package) and FUDANOCR_TENSORBOARD is not "0".
`prediction_table` writes (image | gt | pred) panels as PNG
(`data/png.encode_png`). `Saver` and `guard_run_dir` are the source-
snapshot bookkeeping and overwrite guard of the reference's entry points.
JAX's `profile_trace` (jax.profiler) is not here: torch.profiler takes
its place with the bench work (ROADMAP A3). JAX's `StepTimer` and
`AverageMeter` are not either: no entry point uses them.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import time
from typing import Dict, Optional

import numpy as np

from fudanocr_tpu_torch.data.png import encode_png

log = logging.getLogger("fudanocr_tpu_torch")


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if os.environ.get("FUDANOCR_TENSORBOARD", "1") != "0":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:   # no `tensorboard` package: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def _line(self, record: dict) -> None:
        self._jsonl.write(json.dumps({**record, "time": time.time()}) + "\n")
        self._jsonl.flush()

    def scalar(self, tag: str, value: float, step: int):
        self._line({"tag": tag, "value": float(value), "step": int(step)})
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, metrics: Dict[str, float], step: int,
                prefix: str = ""):
        for k, v in metrics.items():
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def prediction_table(self, step: int, images, gts, preds,
                         palette=((0, 0, 0), (255, 64, 64)),
                         max_rows: int = 8):
        """Write an (image | gt | pred) panel PNG per sample and a JSONL
        index line under <log_dir>/predictions/ (the reference's wandb
        prediction table without wandb); label 255 (ignore) shows grey."""
        out_dir = os.path.join(self.log_dir, "predictions")
        os.makedirs(out_dir, exist_ok=True)
        pal = np.concatenate([np.asarray(palette, np.uint8),
                              np.asarray([[128, 128, 128]], np.uint8)])
        ignore_slot = len(pal) - 1

        def colorize(labels):
            labels = np.asarray(labels)
            idx = np.where(labels == 255, ignore_slot,
                           np.clip(labels, 0, ignore_slot - 1))
            return pal[idx]

        rows = []
        for i in range(min(len(images), max_rows)):
            img = np.asarray(images[i])
            if img.dtype != np.uint8:
                lo, hi = float(img.min()), float(img.max())
                img = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
            panel = np.concatenate([img, colorize(gts[i]),
                                    colorize(preds[i])], axis=1)
            name = f"step{step:08d}_{i}.png"
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(encode_png(panel))
            rows.append(name)
        self._line({"tag": "predictions", "step": int(step), "files": rows})
        return rows

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Saver:
    """Experiment bookkeeping: snapshot the entry point's sources into the
    run dir (sld/util.py:144-173 `saver()`)."""

    def __init__(self, history_dir: str, exp_name: str):
        self.run_dir = os.path.join(history_dir, exp_name)

    def check_exp_name(self, interactive: Optional[bool] = None) -> bool:
        """Overwrite guard (text-gestalt/interfaces/base.py:75-103): a run
        dir that already has contents needs a yes at a tty prompt, and is
        refused without one. Returns True if it is fine to go on."""
        if not os.path.isdir(self.run_dir) or not os.listdir(self.run_dir):
            return True
        if interactive is None:
            interactive = sys.stdin.isatty()
        if not interactive:
            return False
        ans = input(f"experiment dir {self.run_dir} exists — "
                    "overwrite? [y/N] ")
        return ans.strip().lower() in ("y", "yes")

    def snapshot(self, *source_files: str):
        os.makedirs(self.run_dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        open(os.path.join(self.run_dir, stamp), "w").close()
        for src in source_files:
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(self.run_dir,
                                                  os.path.basename(src)))
        return self.run_dir


def guard_run_dir(run_dir: str, sources=(), resume: bool = False) -> bool:
    """Refuse to clobber a run dir that already has contents unless the
    user confirms (tty) or resumes; then snapshot `sources` into it.
    Returns False when the caller should stop. Under a process group rank
    0 alone checks and writes, and every rank gets its answer."""
    from fudanocr_tpu_torch.core.mesh import from_rank0, world

    if world()[0] != 0:
        return from_rank0(None)
    return from_rank0(_guard_run_dir(run_dir, sources, resume))


def _guard_run_dir(run_dir: str, sources, resume: bool) -> bool:
    saver = Saver(os.path.dirname(run_dir) or ".", os.path.basename(run_dir))
    if not resume and not saver.check_exp_name():
        log.error("experiment dir %s already has contents — pass --resume, "
                  "confirm at the prompt, or choose another dir", run_dir)
        return False
    saver.snapshot(*sources)
    return True
