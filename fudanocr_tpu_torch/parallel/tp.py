"""Tensor-parallel parameter placement over a ('data', 'model') device mesh
(port of fudanocr_tpu/parallel/tp.py).

The reference never tensor-parallelises (its largest model is ResNet-50
scale), so the JAX package keeps a 'model' axis open and places
parameters over it for GSPMD. The port's counterpart is a 2-D
`torch.distributed.device_mesh.DeviceMesh` and DTensor placements: a
parameter is replicated over 'data' and, where the rule takes it, sharded
over 'model'.

Layout: flax keeps a Dense or Conv kernel's out-features on its LAST axis,
torch's `Linear` and `Conv` weights on their FIRST (out, in[, kh, kw]).
JAX's rule "shard the last axis of a 2-D+ kernel when it divides" is
therefore dim 0 of the torch weight here: `last_dim_spec` keeps JAX's name
and shards torch's out-features axis. With a model axis of 1 every
parameter is replicated, as in JAX.

The trainers' steps run on the 'data' axis only (`core/mesh`); a whole
step over DTensor parameters is not wired (ROADMAP A8b). The placement and
its numerics are held in tests/test_torch_tp.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def make_mesh(device_type: str = "cuda", data: Optional[int] = None,
              model: int = 1):
    """A ('data', 'model') DeviceMesh over the process group's ranks
    (data x model must be the world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def last_dim_spec(x: torch.Tensor, model_par: int) -> Tuple:
    """Placements over ('data', 'model') for a torch parameter: its
    out-features axis (dim 0; flax's last axis) sharded over 'model' when
    it is 2-D or more and that axis divides by the model axis; replicated
    otherwise, and always over 'data'."""
    from torch.distributed.tensor import Replicate, Shard

    if x.ndim >= 2 and model_par > 1 and x.shape[0] % model_par == 0:
        return (Replicate(), Shard(0))
    return (Replicate(), Replicate())


def shard_params_tp(tree: Dict[str, torch.Tensor],
                    mesh) -> Dict[str, torch.Tensor]:
    """A name -> tensor mapping (a state_dict) as DTensors on `mesh` with
    `last_dim_spec`'s placement; a model axis of 1 degrades to
    replication, so callers may apply it unconditionally."""
    from torch.distributed.tensor import distribute_tensor

    model_par = mesh.size(mesh.mesh_dim_names.index("model"))
    return {k: distribute_tensor(v, mesh, last_dim_spec(v, model_par))
            for k, v in tree.items()}
