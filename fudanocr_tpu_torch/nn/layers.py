"""Basic layers (port of fudanocr_tpu/nn/layers.py).

Numerics follow the PyTorch reference where it departs from the textbook,
exactly as the JAX module does:

* `TorchLayerNorm` divides by the Bessel-corrected std + eps, not
  sqrt(var + eps), with fp32 statistics (scene-text-telescope
  model/tbsrn.py:23-36). It is deliberately not `nn.LayerNorm`.
* `mish` is x * tanh(softplus(x)).
* `PReLU` has one shared slope.
* `pixel_shuffle` is `nn.PixelShuffle` on NCHW, whose channel order
  (c*r^2 + i*r + j) the JAX op reproduces in NHWC.
* `batch_norm(..., train=True)` follows flax, not `nn.BatchNorm2d`: it
  normalises with the biased batch variance and moves `running_var`
  towards that same biased variance (torch's own update uses the
  unbiased one, so the stock module drifts from the JAX `batch_stats`
  after one step). In a data-parallel step (`core/mesh.data_parallel`)
  the statistics are the global batch's, from all-reduced sums.

The `conv2d` / `conv_transpose2d` / `linear` / `batch_norm` /
`layer_norm` helpers run a module's parameters at the activation's dtype
(params stay float32), the port's counterpart of flax's `dtype=` field:
convolutions and products round their operands to it, the norms take
float32 statistics and round only their result. Dropout draws its mask from an explicit
`torch.Generator` on the activation's device (flax's `rngs={"dropout":
...}`); in a data-parallel step every rank draws the global batch's mask
and keeps its own rows.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.core import mesh
from fudanocr_tpu_torch.ops.fused_layernorm import (
    fused_residual_layernorm, fused_residual_layernorm_reference,
    torch_layer_norm)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is in float64: the float32 islands of the
    losses and metrics (flax's `astype(float32)`) keep a float64 run's
    precision, so a data-parallel float64 step sums its shares as one
    process sums the whole."""
    return x if x.dtype == torch.float64 else x.float()


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW sub-pixel upsample (B, C*r^2, H, W) -> (B, C, H*r, W*r)."""
    return F.pixel_shuffle(x, r)


def conv2d(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m` applied at x's dtype (weights cast, params stay float32).

    A bf16 CPU input is convolved in float32 on the bf16 operands and the
    result rounded to bf16 once, flax's rounding point: oneDNN's AMX bf16
    convolution (torch 2.13) returns wrong sums where kernel = stride, as in
    CascadeMiT's spatial reduction `sr` (tests/test_torch_layers_bf16_cpu.py;
    with ONEDNN_MAX_CPU_ISA=AVX512_CORE it rounds once). CUDA runs cuDNN."""
    w = m.weight.to(x.dtype)
    bias = None if m.bias is None else m.bias.to(x.dtype)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv2d(x.float(), w.float(),
                        None if bias is None else bias.float(), m.stride,
                        m.padding, m.dilation, m.groups).to(x.dtype)
    return F.conv2d(x, w, bias, m.stride, m.padding, m.dilation, m.groups)


def conv_transpose2d(m: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """`m` applied at x's dtype, as `conv2d` (a bf16 CPU input convolved in
    float32 and rounded once)."""
    w = m.weight.to(x.dtype)
    bias = None if m.bias is None else m.bias.to(x.dtype)
    args = (m.stride, m.padding, m.output_padding, m.groups, m.dilation)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv_transpose2d(x.float(), w.float(),
                                  None if bias is None else bias.float(),
                                  *args).to(x.dtype)
    return F.conv_transpose2d(x, w, bias, *args)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.linear(x, m.weight.to(x.dtype), bias)


def layer_norm(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """`m` with float32 statistics and affine (float64 in a float64 run),
    output in x's dtype (flax LayerNorm with `dtype=`)."""
    return F.layer_norm(at_least_f32(x), m.normalized_shape, m.weight,
                        m.bias, m.eps).to(x.dtype)


def batch_norm(m: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               train: bool = False) -> torch.Tensor:
    """BatchNorm with float32 statistics and affine, output in x's dtype
    (flax BatchNorm with `dtype=` rounds only its result).

    Inference normalises with the running statistics. `train=True`
    normalises with the biased batch statistics over every axis but 1
    (gradients flow through them) and updates the running statistics in
    place as flax does: `running = (1 - momentum) * running + momentum *
    batch`, with the biased batch variance (torch momentum 0.1 = flax
    momentum 0.9)."""
    if not train:
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight,
                            m.bias, False, 0.0, m.eps)
    if mesh.current() is not None:
        return _global_batch_norm(m, x)
    axes = [0] + list(range(2, x.dim()))
    y = F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0, m.eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x.to(m.running_var.dtype), dim=axes,
                                   correction=0)
        m.running_mean.lerp_(mean, m.momentum)
        m.running_var.lerp_(var, m.momentum)
    return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of the ranks in `group`
    (normalised `xhat = (x - mean) / sqrt(var + eps)`, the biased
    variance): the forward all-reduces the sum, then the sum of squares
    about the mean; the backward all-reduces sum(dy) and sum(dy * xhat)
    once and forms dx = w / sqrt(var + eps) * (dy - mean(dy) - xhat *
    mean(dy * xhat)), cuDNN's form of it (autograd through the forward's
    own steps cancels more in float32). The weight and bias get this
    rank's share, summed over the ranks with the other gradients. Returns
    (y, mean, var) in the statistics' dtype (float32, or float64)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, size):
        axes = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = x.numel() // x.shape[1] * size
        total = x.sum(axes)
        dist.all_reduce(total, group=group)
        mean = total / count
        centred = x - mean.view(shape)
        sq = (centred * centred).sum(axes)
        dist.all_reduce(sq, group=group)
        var = sq / count
        inv = torch.rsqrt(var + eps)
        xhat = centred * inv.view(shape)
        y = xhat if weight is None else (xhat * weight.view(shape)
                                         + bias.view(shape))
        ctx.save_for_backward(xhat, inv, weight)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xhat, inv, weight = ctx.saved_tensors
        axes = [0] + list(range(2, dy.dim()))
        shape = [1, -1] + [1] * (dy.dim() - 2)
        dbias = dy.sum(axes)
        dweight = (dy * xhat).sum(axes)
        sums = torch.cat([dbias, dweight])
        dist.all_reduce(sums, group=ctx.group)
        g_mean, g_xhat = (sums / ctx.count).chunk(2)
        scale = inv if weight is None else inv * weight
        dx = scale.view(shape) * (dy - g_mean.view(shape)
                                  - xhat * g_xhat.view(shape))
        if weight is None:
            return dx, None, None, None, None, None
        return dx, dweight, dbias, None, None, None


def _global_batch_norm(m: nn.modules.batchnorm._BatchNorm,
                       x: torch.Tensor) -> torch.Tensor:
    """Train-mode `batch_norm` over the global batch of a data-parallel
    step (`core/mesh.data_parallel`, `_GlobalBatchNorm`), in float32
    (float64 inputs stay float64); the running statistics move as flax's
    do (C7), not as `nn.SyncBatchNorm`'s unbiased update."""
    mesh_ = mesh.current()
    xs = x if x.dtype in (torch.float32, torch.float64) else x.float()
    w = None if m.weight is None else m.weight.to(xs.dtype)
    b = None if m.bias is None else m.bias.to(xs.dtype)
    y, mean, var = _GlobalBatchNorm.apply(xs, w, b, m.eps, mesh_.group,
                                          mesh_.size)
    with torch.no_grad():
        m.running_mean.lerp_(mean.to(m.running_mean.dtype), m.momentum)
        m.running_var.lerp_(var.to(m.running_var.dtype), m.momentum)
    return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout(rate)` in train mode: keep with probability
    1 - rate and scale kept values by 1 / (1 - rate). The uniform draws
    come from `generator` (the default generator of x's device when
    None), so a run is reproducible from the generator's state."""
    if rate == 0.0:
        return x
    keep = mesh.global_rand(x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TorchLayerNorm(nn.Module):
    """The reference LayerNorm with its `a_2` / `b_2` parameter names.

    `forward(x, residual)` computes LN(x + residual) with the sum taken in
    float32, the JAX module's fused-residual form, through
    `ops.fused_layernorm.fused_residual_layernorm` (the CUDA kernel on
    CUDA tensors). `kernels=False` runs its plain PyTorch version instead,
    on any device (the comparison path). Output dtype follows x.
    """

    def __init__(self, features: int, eps: float = 1e-6,
                 kernels: bool = True):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))
        self.eps = eps
        self.kernels = kernels

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is None:
            return torch_layer_norm(x, self.a_2, self.b_2,
                                    self.eps).to(x.dtype)
        run = (fused_residual_layernorm if self.kernels
               else fused_residual_layernorm_reference)
        return run(x, residual, self.a_2, self.b_2, self.eps)


class PositionwiseFeedForward(nn.Module):
    """Holds the reference's `pff.w_1` / `pff.w_2` linears."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)


class PReLU(nn.PReLU):
    """torch's PReLU with its default single slope (init 0.25), applied at
    the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class ConvBNReLU(nn.Sequential):
    """conv3x3 + BatchNorm + ReLU (stn_head.py:13-22): keys `0` and `1`."""

    def __init__(self, in_features: int, features: int):
        super().__init__(nn.Conv2d(in_features, features, 3, 1, 1),
                         nn.BatchNorm2d(features), nn.ReLU())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(batch_norm(self[1], conv2d(self[0], x), train))


def max_pool(x: torch.Tensor, window: Union[int, Tuple[int, int]],
             strides: Optional[Union[int, Tuple[int, int]]] = None,
             padding: Union[int, Tuple[int, int]] = 0) -> torch.Tensor:
    """NCHW max pool; `padding` pads with -inf as flax's explicit padding
    does, so the pooled values agree."""
    return F.max_pool2d(x, window, strides if strides is not None else window,
                        padding)
