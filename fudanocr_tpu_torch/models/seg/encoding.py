"""Encoding layer, EncNet's learnable residual encoder (port of
fudanocr_tpu/models/seg/encoding.py; reference text-focused-Transformers/
mmseg/ops/encoding.py:8-74): K codewords and K smoothing scales; every
feature soft-assigns itself to the codewords by scaled squared L2
distance, and each codeword aggregates the assignment-weighted residuals.

(B, C, H, W) NCHW in -> (B, K, C) out. Keys `codewords` (K, C) and
`scale` (K,), mmseg's and the JAX module's names. No textformer config
reaches it. `dtype` rounds the input; the math then runs in float32, as
the JAX module's does (its float32 parameters promote it).
"""

from __future__ import annotations

import torch
from torch import nn


class Encoding(nn.Module):
    def __init__(self, channels: int, num_codes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        std = 1.0 / (num_codes * channels) ** 0.5
        self.codewords = nn.Parameter(
            torch.empty(num_codes, channels).uniform_(-std, std))
        self.scale = nn.Parameter(torch.empty(num_codes).uniform_(-1, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        feats = x.to(self.dtype).flatten(2).transpose(1, 2)      # (B, N, C)
        resid = feats[:, :, None, :] - self.codewords            # (B, N, K, C)
        dist = self.scale * resid.float().pow(2).sum(-1)         # (B, N, K)
        assign = torch.softmax(dist, dim=2)
        return torch.einsum("bnk,bnkc->bkc", assign.to(resid.dtype), resid)
