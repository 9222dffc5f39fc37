"""Recurrent layers (port of fudanocr_tpu/nn/recurrent.py).

The JAX package scans GRUs and LSTMs with `lax.scan`; here the
bidirectional layers are torch's own (cuDNN on the card) with the same gate
orders and updates: LSTM [i, f, g, o] with c' = f*c + i*g,
h' = o*tanh(c'); GRU [r, z, n] with n = tanh(x_n + r*(W_hn h + b_hn)),
h' = (1-z)*n + z*h. Their weights carry the names the JAX package's
`birnn` porter reads (`weight_ih_l0`, `weight_hh_l0`, `bias_ih_l0`,
`bias_hh_l0` and their `_reverse` twins).
"""

from __future__ import annotations

import torch
from torch import nn

from fudanocr_tpu_torch.nn.layers import conv2d
from fudanocr_tpu_torch.ops.fused_gru import (fused_bigru_x,
                                              fused_bigru_x_reference,
                                              fused_gru_supported,
                                              kernel_takes)


class BiLSTM(nn.LSTM):
    """Bidirectional LSTM over batch-major (B, T, In) -> (B, T, 2*hidden).

    Gate math runs in float32 whatever the input dtype (as the JAX module
    and cuDNN do); the output is cast back to the input dtype."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__(input_size, hidden, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = super().forward(x.float())
        return y.to(x.dtype)


class BiGRU(nn.GRU):
    """Bidirectional GRU over batch-major (B, T, In) -> (B, T, 2*hidden),
    gate math in float32 whatever the input dtype, output cast back.

    With `fuse` on, at inference (`train=False`), where
    `fused_gru_supported(B, T, hidden)` (JAX's gate) holds and the kernel
    takes C and the hidden size (`kernel_takes`), x and this module's own
    parameters go to `ops.fused_gru.fused_bigru_x`: both input projections
    and the recurrence of both directions in one kernel launch on CUDA
    tensors, its plain version on CPU tensors (`kernels=False`: the plain
    version on any device). Everything else, training included, runs
    torch's GRU (cuDNN on the card) with autograd, as the JAX module keeps
    its scan."""

    def __init__(self, input_size: int, hidden: int, fuse: bool = False,
                 kernels: bool = True):
        super().__init__(input_size, hidden, batch_first=True,
                         bidirectional=True)
        self.fuse, self.kernels = fuse, kernels

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, t, c = x.shape
        hidden = self.hidden_size
        if (self.fuse and not train and kernel_takes(c, hidden)
                and fused_gru_supported(b, t, hidden)):
            run = fused_bigru_x if self.kernels else fused_bigru_x_reference
            return run(x.contiguous(), self.weight_ih_l0, self.bias_ih_l0,
                       self.weight_hh_l0, self.bias_hh_l0,
                       self.weight_ih_l0_reverse, self.bias_ih_l0_reverse,
                       self.weight_hh_l0_reverse, self.bias_hh_l0_reverse,
                       hidden)
        y, _ = super().forward(x.float())
        return y.to(x.dtype)


class SpatialGRU(nn.Module):
    """The SR nets' GruBlock (reference tsrn.py:123-145): a 1x1 conv, then
    a BiGRU along one spatial axis with the other folded into the batch,
    `features // 2` hidden units per direction.

    NHWC (B, H, W, C) in and out, as the JAX module: `axis="H"` scans
    along H (the W columns folded into the batch), `axis="W"` along W.
    Keys `conv1` and `gru`, as the reference's GruBlock."""

    def __init__(self, features: int, axis: str = "H", fuse: bool = False,
                 kernels: bool = True):
        super().__init__()
        if features % 2 or axis not in ("H", "W"):
            raise ValueError(f"SpatialGRU needs even features and axis H or "
                             f"W, got {features}, {axis!r}")
        self.axis = axis
        self.conv1 = nn.Conv2d(features, features, 1)
        self.gru = BiGRU(features, features // 2, fuse=fuse, kernels=kernels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d(self.conv1, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        b, h, w, c = x.shape
        if self.axis == "H":
            seq = x.transpose(1, 2).reshape(b * w, h, c)
        else:
            seq = x.reshape(b * h, w, c)
        y = self.gru(seq, train)
        if self.axis == "H":
            return y.reshape(b, w, h, c).transpose(1, 2)
        return y.reshape(b, h, w, c)
