"""Checkpoint directories in the JAX package's layout (port of
fudanocr_tpu/core/checkpoint.py) with the port's own payload.

A checkpoint is a directory holding

  state.pt   — the port's payload, written by `torch.save`
  meta.json  — step, best metrics and the like

`save` writes atomically (a temporary directory, then a rename), so a
killed run never leaves a half-written checkpoint. JAX's `state.msgpack`
(flax serialization) is not read or written yet: that interchange is
ROADMAP A4, which adds it beside `state.pt`.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

PAYLOAD = "state.pt"


def save(path: str, payload: Any, meta: Optional[Dict] = None) -> None:
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        torch.save(payload, os.path.join(tmp, PAYLOAD))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta or {}, f, indent=1, default=str)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def load(path: str, map_location=None) -> Any:
    return torch.load(os.path.join(path, PAYLOAD), map_location=map_location)


def load_meta(path: str) -> Dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def latest(ckpt_dir: str, prefix: str = "") -> Optional[str]:
    """The checkpoint subdirectory of `ckpt_dir` (names starting with
    `prefix`) whose meta.json has the largest step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    subs = [d for d in os.listdir(ckpt_dir)
            if os.path.isdir(os.path.join(ckpt_dir, d))
            and d.startswith(prefix)
            and os.path.exists(os.path.join(ckpt_dir, d, "meta.json"))]
    if not subs:
        return None

    def step_of(d):
        try:
            return load_meta(os.path.join(ckpt_dir, d)).get("step", -1)
        except (OSError, ValueError):
            return -1

    return os.path.join(ckpt_dir, max(subs, key=step_of))
