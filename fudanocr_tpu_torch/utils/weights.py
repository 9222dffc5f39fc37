"""Move the JAX package's variables into the port's modules.

Every port module carries the original FudanOCR state_dict key layout that
`fudanocr_tpu.utils.torch_port` reads, so the JAX package's own exporter
(`fudanocr_tpu.utils.torch_export.export_state_dict`, which inverts a
porter mechanically) turns JAX variables into the port's state_dict with no
mapping code here; `to_jax_variables` runs the porter itself for the way
back. Both import the JAX package's module inside the function: they are
for the CPU tests and for users with a JAX checkpoint, and the port itself
never needs them.
"""

from __future__ import annotations

import torch
from torch import nn


def load_jax_variables(module: nn.Module, porter: str, variables,
                       **porter_kwargs) -> nn.Module:
    """Load JAX `variables` ({"params": ..., "batch_stats": ...}, nested
    dicts of arrays) into `module` through porter `porter` ("tbsrn",
    "crnn", ...), strictly. `porter_kwargs` go to the porter (e.g.
    srb_nums=2 for TBSRN). Returns the module."""
    from fudanocr_tpu.utils.torch_export import export_state_dict

    template = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    state = export_state_dict(porter, variables, template, **porter_kwargs)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return module


def to_jax_variables(module: nn.Module, porter: str, **porter_kwargs):
    """The reverse direction: `module`'s state_dict through the JAX
    package's forward porter `porter`, giving {"params": ...,
    "batch_stats": ...} as nested dicts of numpy arrays (how the tests
    hold the port's updated parameters against the JAX package's)."""
    from fudanocr_tpu.utils.torch_port import PORTERS

    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    return PORTERS[porter](state, **porter_kwargs)
