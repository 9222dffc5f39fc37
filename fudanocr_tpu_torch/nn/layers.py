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

The `conv2d` / `linear` / `batch_norm` helpers run a module's parameters at
the activation's dtype (params stay float32), the port's counterpart of
flax's `dtype=` field.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW sub-pixel upsample (B, C*r^2, H, W) -> (B, C, H*r, W*r)."""
    return F.pixel_shuffle(x, r)


def conv2d(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m` applied at x's dtype (weights cast, params stay float32)."""
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), bias, m.stride, m.padding)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.linear(x, m.weight.to(x.dtype), bias)


def batch_norm(m: nn.modules.batchnorm._BatchNorm,
               x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm: float32 statistics and affine, output in x's
    dtype (flax BatchNorm with `dtype=` rounds only its result)."""
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                        False, 0.0, m.eps)


def torch_layer_norm(v: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(v - mean) / (unbiased_std + eps) * scale + bias, all in float32."""
    v = v.float()
    mean = v.mean(-1, keepdim=True)
    d = v - mean
    var = (d * d).sum(-1, keepdim=True) / max(v.shape[-1] - 1, 1)
    return d / (var.sqrt() + eps) * scale.float() + bias.float()


class TorchLayerNorm(nn.Module):
    """The reference LayerNorm with its `a_2` / `b_2` parameter names.

    `forward(x, residual)` computes LN(x + residual) with the sum taken in
    float32, the JAX module's fused-residual form. Output dtype follows x.
    """

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        v = x.float() if residual is None else x.float() + residual.float()
        return torch_layer_norm(v, self.a_2, self.b_2, self.eps).to(x.dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm(self[1], conv2d(self[0], x)))


def max_pool(x: torch.Tensor, window: Union[int, Tuple[int, int]],
             strides: Optional[Union[int, Tuple[int, int]]] = None,
             padding: Union[int, Tuple[int, int]] = 0) -> torch.Tensor:
    """NCHW max pool; `padding` pads with -inf as flax's explicit padding
    does, so the pooled values agree."""
    return F.max_pool2d(x, window, strides if strides is not None else window,
                        padding)
