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

A step over placed parameters (`TensorParallel`, the function GSPMD
computes for JAX's sharded step). The port's modules call `F.conv2d` /
`F.linear` on `weight.to(dtype)` and its kernels take `data_ptr()`, which a
sharded DTensor gives neither, so each rank keeps its placed parameters as
plain tensors (its shard of each parameter sharded over 'model', the whole
of each replicated one) and the optimizer's state is that of those
tensors. A call gathers every sharded parameter over the model group into
a plain tensor through an autograd-aware all-gather (`core/mesh.gather_dim0`:
gloo stages CUDA tensors through host memory) and runs the module
unchanged under `torch.func.functional_call`. The model group's ranks
compute the same rows, so each computes the whole gradient: the backward
reduce-scatters it, as the mean over the group (exact for two equal
copies), to this rank's shard, and takes the group's mean of each
replicated parameter's gradient, so that the ranks' copies stay equal.
The step then sums over 'data' (`core/mesh.all_reduce_grads`), and the
clip's global norm counts each sharded parameter's squares over the model
group once (`train/state.AdamWithClip`, which reads `model_group` from a
shard). BatchNorm statistics are buffers of the module: replicated and
outside the placement, as JAX's `shard_params` covers `params` only. With a
model axis of 1 nothing is gathered and the step is the data-parallel one.

The placement and its numerics are held in tests/test_torch_tp.py, the
step in tests/test_torch_tp_step.py.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from fudanocr_tpu_torch.core import mesh as mesh_lib


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


def axis(mesh, name: str) -> mesh_lib.Mesh:
    """One axis of a ('data', 'model') DeviceMesh as a `core/mesh.Mesh`:
    its size, this rank's index on it and its process group (None where
    the axis holds one rank)."""
    size = mesh.size(mesh.mesh_dim_names.index(name))
    return mesh_lib.Mesh(size, mesh.get_local_rank(name),
                         mesh.get_group(name) if size > 1 else None)


class _ModelAxis(torch.autograd.Function):
    """Forward: the model group's shards along dim 0 in rank order, or,
    not `shard`, x itself (a replicated parameter). Backward: the group's
    mean of the gradient, this rank's rows of it where x is a shard."""

    @staticmethod
    def forward(ctx, x, group, size, index, shard):
        ctx.group, ctx.size, ctx.index, ctx.n = group, size, index, x.shape[0]
        ctx.shard = shard
        return mesh_lib.gather_dim0(x, group, size) if shard else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        g = g / ctx.size
        if ctx.shard:
            g = g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n]
        return g, None, None, None, None


class TensorParallel:
    """`module`'s parameters placed over a ('data', 'model') DeviceMesh
    (`last_dim_spec`) and a call that runs the module on them (module
    docstring). Every rank must hold the same `module` (built from one
    seed): each cuts its shards locally, which needs no collective (gloo
    scatters no CUDA tensor). Build the optimizer over `parameters()`. The
    module's own tensors of the sharded parameters are neither read nor
    updated by a call; `write_back()` gathers the placed values into them
    (to evaluate, save or compare the module)."""

    def __init__(self, module: torch.nn.Module, mesh):
        self.module, self.mesh = module, mesh
        self.model = axis(mesh, "model")
        self.data = axis(mesh, "data")
        self.specs, self.local = {}, {}
        for name, p in module.named_parameters():
            spec = last_dim_spec(p, self.model.size)
            if spec[1].is_shard():
                t = torch.nn.Parameter(
                    p.detach().chunk(self.model.size)[self.model.index]
                    .clone(), requires_grad=p.requires_grad)
                t.model_group = self.model.group
            else:
                t = p
            self.specs[name], self.local[name] = spec, t

    def parameters(self) -> Iterator[torch.nn.Parameter]:
        """This rank's placed parameters: its shards and the replicated
        parameters (the module's own)."""
        return iter(self.local.values())

    def named_parameters(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, placed parameter), the module's names."""
        return iter(self.local.items())

    def named_buffers(self):
        """The module's buffers (BatchNorm statistics: replicated)."""
        return self.module.named_buffers()

    def placed(self) -> Dict[str, torch.Tensor]:
        """name -> the placed parameter as a DTensor (this rank's local
        tensor, no collective)."""
        from torch.distributed.tensor import DTensor

        return {k: DTensor.from_local(t.detach(), self.mesh, self.specs[k],
                                      run_check=False)
                for k, t in self.local.items()}

    def full_parameters(self) -> Dict[str, torch.Tensor]:
        """name -> the whole parameter as a plain tensor, differentiable
        into the placed ones (the gather, and the mean of a replicated
        parameter's gradient, over the model group)."""
        m = self.model
        if m.size == 1:
            return dict(self.local)
        return {k: _ModelAxis.apply(t, m.group, m.size, m.index,
                                    self.specs[k][1].is_shard())
                for k, t in self.local.items()}

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.module,
                                          self.full_parameters(), args,
                                          kwargs)

    def write_back(self) -> None:
        """The gathered parameters into the module's own tensors."""
        with torch.no_grad():
            full = self.full_parameters()
            for name, p in self.module.named_parameters():
                if p is not self.local[name]:
                    p.copy_(full[name])
