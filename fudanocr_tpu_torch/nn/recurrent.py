"""Recurrent layers (port of fudanocr_tpu/nn/recurrent.py).

The JAX package scans LSTMs with `lax.scan`; here the bidirectional LSTM is
torch's own (cuDNN on the card) with the same gate order [i, f, g, o] and
update c' = f*c + i*g, h' = o*tanh(c'). Its weights carry the names the
JAX package's `birnn` porter reads (`weight_ih_l0`, `weight_hh_l0`,
`bias_ih_l0`, `bias_hh_l0` and their `_reverse` twins).
"""

from __future__ import annotations

import torch
from torch import nn


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
