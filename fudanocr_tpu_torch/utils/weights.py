"""Move the JAX package's variables into the port's modules and back.

Every port module carries the original FudanOCR state_dict key layout that
the porters of `utils/porters.py` read (the port's copy of the JAX
package's `utils/torch_port.py`). A porter only moves elements, so its
inverse is recovered mechanically, as the JAX package's
`utils/torch_export.py:40-165` does and this module repeats:

1. tag every element of the module's state_dict with its flat position
   (int index arrays of the original shapes);
2. run the porter once over those index arrays: the resulting tree holds,
   at each position, which state_dict element feeds it;
3. scatter the JAX variables back through that mapping.

`load_jax_variables` does that; `to_jax_variables` runs the porter itself
for the way back, on a module or on any state_dict-like mapping, such as
`grad_state_dict(module)`, which puts each parameter's gradient where the
parameter was: through the porter it gives the gradients in the JAX
layout beside the (updated) BatchNorm statistics. Keys the porter never
reads (BatchNorm `num_batches_tracked`) keep the module's values.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from fudanocr_tpu_torch.utils.porters import PORTERS


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Depth-first (path, leaf) pairs over nested mappings."""
    if hasattr(tree, "items"):
        for k in sorted(tree.keys()):
            yield from _walk(tree[k], path + (str(k),))
    else:
        yield path, tree


def trace_porter(porter: str, shapes: Dict[str, Tuple[int, ...]],
                 **porter_kwargs):
    """Run porter `porter` over index-coded arrays of the given state_dict
    `shapes`. Returns (index tree, {key: (offset, shape)}, total)."""
    key_meta: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
    off = 0
    for k, shape in shapes.items():
        key_meta[k] = (off, shape)
        off += int(np.prod(shape, dtype=np.int64))
    idx_dtype = np.int32 if off < 2 ** 31 else np.int64
    base = np.arange(off, dtype=idx_dtype)
    sd_idx = {k: base[o:o + int(np.prod(s, dtype=np.int64))].reshape(s)
              for k, (o, s) in key_meta.items()}
    return PORTERS[porter](sd_idx, **porter_kwargs), key_meta, off


def export_state_dict(porter: str, variables, template: Dict[str, Any],
                      **porter_kwargs) -> Dict[str, torch.Tensor]:
    """Invert PORTERS[porter]: JAX `variables` -> a state_dict with the
    keys, shapes and dtypes of `template` (a torch state_dict). Values the
    porter never reads are the template's. Raises where the trees do not
    match, or where one state_dict element would get two values."""
    shapes = {k: tuple(v.shape) for k, v in template.items()}
    idx_tree, key_meta, total = trace_porter(porter, shapes, **porter_kwargs)

    idx_leaves = dict(_walk(idx_tree))
    val_leaves = dict(_walk(variables))
    missing = sorted(set(idx_leaves) - set(val_leaves))
    extra = sorted(set(val_leaves) - set(idx_leaves))
    if missing or extra:
        raise ValueError(f"variables do not match porter {porter!r}: "
                         f"missing={missing[:5]} extra={extra[:5]}")

    flat = np.zeros((total,), np.float64)
    filled = np.zeros((total,), bool)
    for path, idx in idx_leaves.items():
        idx = np.asarray(idx)
        if idx.dtype not in (np.int32, np.int64):
            raise ValueError(f"porter leaf {'/'.join(path)} synthesizes "
                             "values; it cannot be inverted")
        val = np.asarray(val_leaves[path], np.float64)
        if val.shape != idx.shape:
            raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                             f"variables {val.shape} vs module {idx.shape}")
        ids, vals = idx.ravel(), val.ravel()
        if np.unique(ids).size != ids.size:
            order = np.argsort(ids, kind="stable")
            si, sv = ids[order], vals[order]
            if not ((si[1:] != si[:-1]) | (sv[1:] == sv[:-1])).all():
                raise ValueError(f"leaf {'/'.join(path)} maps one element "
                                 "to several values")
        dup = filled[ids]
        if dup.any() and not np.array_equal(flat[ids[dup]], vals[dup]):
            raise ValueError(f"leaf {'/'.join(path)} re-writes elements "
                             "with other values")
        flat[ids] = vals
        filled[ids] = True

    out: Dict[str, torch.Tensor] = {}
    for k, (off, shape) in key_meta.items():
        n = int(np.prod(shape, dtype=np.int64))
        got = filled[off:off + n]
        if got.all():
            out[k] = torch.from_numpy(flat[off:off + n].reshape(shape)).to(
                template[k].dtype)
        elif not got.any():
            out[k] = template[k].clone()
        else:
            raise ValueError(f"key {k!r} only partly mapped "
                             f"({int(got.sum())}/{n} elements)")
    return out


def load_jax_variables(module: nn.Module, porter: str, variables,
                       **porter_kwargs) -> nn.Module:
    """Load JAX `variables` ({"params": ..., "batch_stats": ...}, nested
    dicts of arrays) into `module` through porter `porter` ("tbsrn",
    "crnn", "segmentor", ...), strictly. `porter_kwargs` go to the porter
    (e.g. srb_nums=2 for TBSRN). Returns the module."""
    template = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    module.load_state_dict(export_state_dict(porter, variables, template,
                                             **porter_kwargs))
    return module


def grad_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module`'s state_dict with every parameter replaced by its gradient
    (zeros where it has none); buffers as they are."""
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in module.named_parameters()}
    return {k: grads.get(k, v) for k, v in module.state_dict().items()}


def to_jax_variables(module: Union[nn.Module, Mapping[str, torch.Tensor]],
                     porter: str, **porter_kwargs):
    """The reverse direction: `module`'s state_dict (or a state_dict-like
    mapping) through porter `porter`, giving {"params": ...,
    "batch_stats": ...} as nested dicts of numpy arrays."""
    sd = module.state_dict() if isinstance(module, nn.Module) else module
    state = {k: v.detach().cpu() for k, v in sd.items()}
    return PORTERS[porter](state, **porter_kwargs)
