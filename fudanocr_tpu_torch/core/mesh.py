"""Data-parallel runs over torch.distributed (port of fudanocr_tpu/core/
mesh.py).

JAX jits a step over a mesh whose 'data' axis shards the batch: the
program is the one-device program on the global batch, and XLA inserts
the collectives. The port runs one process per card (torchrun), each
holding the rows [k·b, (k+1)·b) of every global batch of b·N rows, and
computes the same function: every mean, BatchNorm statistic and sort that
JAX takes over the global batch is taken over it here too, through the
collectives below, and each rank's loss is its share of the global loss
(the shares sum to it), so the summed gradients are the global batch's.

* `setup_distributed()` reads torchrun's environment (RANK, WORLD_SIZE,
  LOCAL_RANK, MASTER_ADDR/PORT) and starts the process group: NCCL for a
  CUDA device, gloo on the CPU. Without that environment it does
  nothing, as JAX's does on one host.
* `make_mesh_for_batch(batch)` is JAX's gcd rule: gcd(world, batch) ranks
  form the 'data' axis, and the rest sit the run out.
* A trainer runs its step inside `data_parallel(mesh)`. The modules read
  the active mesh there (`current()`): `nn/layers.batch_norm` reduces its
  statistics, `global_rand` draws the global batch's uniforms and keeps
  this rank's rows (dropout, drop-path), `batch_offset` keys the hash-
  dropout kernels on the global image index, the losses divide by the
  all-reduced denominators. With no active mesh, or a mesh of one rank,
  every helper is the identity and each path computes bit for bit what
  it computes without this module.

The collectives that autograd passes through are `torch.autograd.Function`s
of this module: the sum all-reduce (its backward all-reduces the
gradient) and the all-gather along dim 0 in rank order (its backward
all-reduces and keeps this rank's rows). Gloo has no all-gather of CUDA
tensors, so under gloo a CUDA tensor is gathered through host memory;
NCCL gathers on the card.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("fudanocr_tpu_torch.mesh")


@dataclass(frozen=True)
class Mesh:
    """The 'data' axis of a run: `size` ranks, this process at `index` on
    it (None: it sits the run out), `group` their process group (None
    with one rank)."""

    size: int = 1
    index: Optional[int] = 0
    group: Any = None

    @property
    def active(self) -> bool:
        """This process computes on the axis."""
        return self.index is not None

    @property
    def writer(self) -> bool:
        """This process writes checkpoints and logs (index 0)."""
        return self.index == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n` rows."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not divide across "
                             f"{self.size} ranks")
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)

    @property
    def shard(self) -> Tuple[int, int]:
        """(index, size): what the datasets' `batches(shard=)` take."""
        return self.index, self.size


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def setup_distributed(device: str = "cuda", init_method: Optional[str] = None,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None,
                      backend: Optional[str] = None) -> int:
    """Start the process group (replaces init_dist / NCCL process groups,
    text-focused-Transformers/tools/train.py:150-159); returns this
    process's rank.

    The rank, world size and rendezvous come from the arguments, else from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT
    through init_method "env://"). With neither, or a group already up,
    nothing is started. A CUDA `device` takes NCCL (or `backend`: gloo
    lets several ranks share one card, which NCCL refuses) and makes the
    card `local_device(device)` names current; anything else takes
    gloo."""
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    cuda = torch.device(device).type == "cuda"
    if cuda and local_device(device).index is not None:
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return rank


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: `cuda` becomes cuda:LOCAL_RANK under
    torchrun; any other name is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None \
            and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def make_mesh_for_batch(batch_size: int) -> Mesh:
    """A 'data' axis that divides `batch_size`: gcd(world, batch) ranks
    (unused ranks sit the run out rather than forcing padded batches).
    Every rank of the group must call it (a partial axis makes a group)."""
    rank, n = world()
    data = math.gcd(n, batch_size)
    if data < n:
        logging.getLogger("fudanocr_tpu.mesh").warning(
            "batch %d does not divide across %d devices: using %d, "
            "leaving %d idle — pad the batch to a multiple of %d to use "
            "all devices", batch_size, n, data, n - data, n)
    if data == 1:
        return Mesh(1, 0 if rank == 0 else None, None)
    group = (dist.group.WORLD if data == n
             else dist.new_group(list(range(data))))
    return Mesh(data, rank if rank < data else None, group)


def from_rank0(value):
    """Rank 0's `value` on every rank of the process group (a picklable
    object); the value itself without a group."""
    if world()[1] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def local_batch_size(global_batch: int) -> int:
    """Per-process batch of a multi-process run."""
    return global_batch // world()[1]


def host_shard_indices(n: int, batch_size: int) -> range:
    """Per-process index striping over a dataset of size n, the
    DistributedSampler equivalent (mmseg/datasets/samplers/
    distributed_sampler.py:13-48): process k reads every world-th batch of
    `batch_size`, so of each global batch its rows [k·b, (k+1)·b)."""
    rank, size = world()
    return range(rank * batch_size, n, size * batch_size)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a host batch: an array or a list (one entry a
    row, as labels), or a dict or tuple of them; other values are kept."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(mesh, v) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor, list)):
        return batch[mesh.rows(len(batch))]
    return batch


def rank_batches(data, batch_size: int, mesh: Mesh, **kw) -> Iterator:
    """`data.batches(batch_size, **kw)` as this rank sees them: its rows
    of each global batch. A dataset with `builds_rows` builds only those
    (`batches(..., shard=mesh.shard)`); any other builds the whole batch
    and the rows are cut from it. With one rank, `data.batches` itself."""
    if mesh.size == 1:
        return data.batches(batch_size, **kw)
    if getattr(data, "builds_rows", False):
        return data.batches(batch_size, shard=mesh.shard, **kw)
    return (shard_batch(mesh, b) for b in data.batches(batch_size, **kw))


# -- the active mesh ---------------------------------------------------------
#
# A dynamic scope, as torch.no_grad is: `data_parallel` sets it around a
# step and restores it after, so the modules deep inside a forward (BatchNorm,
# dropout, the attention's kernel offset, the losses) read it without every
# forward taking a mesh argument. The collectives' backwards, which run on
# autograd's threads, keep their group in their context and never read it.

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the body on `mesh`'s data axis (a mesh of one rank, or None,
    leaves the body as it is)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def current() -> Optional[Mesh]:
    """The active mesh of more than one rank, else None."""
    return _ACTIVE


def batch_offset(b: int) -> int:
    """The global index of this rank's first image, given its `b` rows."""
    m = _ACTIVE
    return 0 if m is None else m.index * b


def global_rand(shape: Sequence[int], generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """torch.rand of the global batch's `shape` (dim 0 the rank's rows
    times the ranks), drawn whole from `generator` on every rank, this
    rank's rows kept: the draws do not depend on the world size, and the
    generators stay in step."""
    m = _ACTIVE
    if m is None:
        return torch.rand(shape, generator=generator, device=device)
    b = shape[0]
    full = torch.rand((b * m.size, *shape[1:]), generator=generator,
                      device=device)
    return full[m.index * b:(m.index + 1) * b]


# -- collectives -------------------------------------------------------------

def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def gather_dim0(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The `size` ranks' x of `group` concatenated along dim 0 in rank
    order, no gradient (a CUDA tensor through host memory under gloo)."""
    src = x.detach().contiguous()
    if _via_host(src, group):     # gloo gathers host tensors only
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.index, ctx.n = group, index, x.shape[0]
        return gather_dim0(x, group, size)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the active mesh's ranks (x itself without one);
    differentiable: the gradient is all-reduced in turn."""
    m = _ACTIVE
    return x if m is None else _AllReduceSum.apply(x, m.group)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x concatenated along dim 0 in rank order (x itself
    without an active mesh); differentiable: each rank's rows get the sum
    of the ranks' gradients of them."""
    m = _ACTIVE
    return x if m is None else _AllGather.apply(x, m.group, m.size, m.index)


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global batch's mean of x, for a loss:
    x.sum() over the global element count (x.mean() without an active
    mesh); the ranks' shares sum to the mean. The ranks hold equal parts
    of the batch."""
    m = _ACTIVE
    return x.mean() if m is None else x.sum() / (x.numel() * m.size)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of x on every rank, for a metric (x.mean()
    without an active mesh)."""
    m = _ACTIVE
    if m is None:
        return x.mean()
    return all_reduce_sum(x.sum()) / (x.numel() * m.size)


def global_values(values: dict) -> dict:
    """0-d shares (a step's loss terms) summed over the active mesh's
    ranks in one all-reduce, each back at its dtype; the values
    themselves without one."""
    m = _ACTIVE
    if m is None or not values:
        return values
    total = all_reduce_sum(torch.stack(
        [v.detach().to(torch.float64) for v in values.values()]))
    return {k: t.to(v.dtype) for (k, v), t in zip(values.items(), total)}


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     mesh: Optional[Mesh]) -> None:
    """Sum the parameters' gradients over `mesh`'s ranks in place, in one
    all-reduce per dtype (the parameters' order is every rank's)."""
    if mesh is None or mesh.size == 1:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def reduce_sums(values: Sequence[float], mesh: Optional[Mesh],
                device=None) -> List[float]:
    """Host numbers summed over `mesh`'s ranks, in float64 (the values
    themselves with one rank); `device` is the card NCCL reduces on."""
    if mesh is None or mesh.size == 1:
        return [float(v) for v in values]
    t = torch.tensor(list(values), dtype=torch.float64)
    if dist.get_backend(mesh.group) == "nccl":
        t = t.to(device)
    dist.all_reduce(t, group=mesh.group)
    return [float(v) for v in t.cpu()]
