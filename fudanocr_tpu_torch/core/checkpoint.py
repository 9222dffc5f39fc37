"""Checkpoint directories in the JAX package's layout (port of
fudanocr_tpu/core/checkpoint.py), with the port's own payload beside
JAX's.

A checkpoint is a directory holding

  state.pt       — the port's payload, written by `torch.save`
  state.msgpack  — the JAX package's tree ({"params", "batch_stats"[,
                   "opt_state"]}), the bytes `flax.serialization.to_bytes`
                   writes (`core/serialization.py`: no flax, no msgpack)
  meta.json      — step, best metrics and the like

either payload or both. `save` writes state.pt (and state.msgpack when it
is given the JAX tree), `save_jax` state.msgpack alone; both write
atomically (a temporary directory, then a rename), so a killed run never
leaves a half-written checkpoint. `load_model_state` reads a model's
weights from either file: state.msgpack goes through the model's porter
(`utils/weights.py`), which checks the tree's keys and shapes.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from fudanocr_tpu_torch.core import serialization
from fudanocr_tpu_torch.utils.weights import export_state_dict, porter_of

PAYLOAD = "state.pt"
JAX_STATE = "state.msgpack"


def _write(path: str, meta: Optional[Dict], payload: Any = None,
           jax_tree: Any = None) -> None:
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        if payload is not None:
            torch.save(payload, os.path.join(tmp, PAYLOAD))
        if jax_tree is not None:
            with open(os.path.join(tmp, JAX_STATE), "wb") as f:
                f.write(serialization.to_bytes(jax_tree))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta or {}, f, indent=1, default=str)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def save(path: str, payload: Any, meta: Optional[Dict] = None,
         jax_tree: Any = None) -> None:
    """state.pt (and, given `jax_tree`, state.msgpack) and meta.json."""
    _write(path, meta, payload=payload, jax_tree=jax_tree)


def save_jax(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """A checkpoint the JAX package writes: state.msgpack and meta.json."""
    _write(path, meta, jax_tree=tree)


def has_payload(path: str) -> bool:
    return os.path.exists(os.path.join(path, PAYLOAD))


def has_jax_state(path: str) -> bool:
    return os.path.exists(os.path.join(path, JAX_STATE))


def load(path: str, map_location=None) -> Any:
    return torch.load(os.path.join(path, PAYLOAD), map_location=map_location)


def load_jax(path: str) -> Any:
    """The tree of `path`/state.msgpack (nested dicts of numpy arrays)."""
    with open(os.path.join(path, JAX_STATE), "rb") as f:
        return serialization.from_bytes(f.read())


def jax_state_dict(tree: Any, module: torch.nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """The "params" and "batch_stats" of a JAX checkpoint's `tree` as a
    state_dict of `module`'s layout (CPU tensors), through `module`'s own
    porter (`jax_porter`); a tree that does not match the porter's raises.
    Values the porter never reads (BatchNorm `num_batches_tracked`) are
    the module's."""
    porter, porter_kwargs = porter_of(module)
    template = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    variables = {k: tree[k] for k in ("params", "batch_stats") if k in tree}
    return export_state_dict(porter, variables, template, **porter_kwargs)


def load_model_state(path: str, map_location=None,
                     module: Optional[torch.nn.Module] = None) -> Dict:
    """The model state_dict of the checkpoint directory `path`: state.pt's
    "state_dict" where the directory has one, else state.msgpack's
    variables through `jax_state_dict` into the layout of `module`, which
    that route needs. Load the result with `module.load_state_dict` (not
    under inference mode), which rebuilds cached kernel operands."""
    if has_payload(path):
        return load(path, map_location)["state_dict"]
    if not has_jax_state(path):
        raise FileNotFoundError(f"{path}: no {PAYLOAD} or {JAX_STATE}")
    if module is None:
        raise ValueError(f"{path} holds only {JAX_STATE}: reading it needs "
                         "the module it is loaded into")
    sd = jax_state_dict(load_jax(path), module)
    if map_location is not None:
        sd = {k: v.to(map_location) for k, v in sd.items()}
    return sd


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
