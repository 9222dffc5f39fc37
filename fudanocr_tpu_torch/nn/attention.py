"""Multi-head attention and sinusoidal positional encodings (port of
fudanocr_tpu/nn/attention.py).

The encodings are host-side numpy constants copied from the JAX module
(which cannot be imported here: it pulls in jax). The attention is the
self-attention plain path only; it keeps the reference's four linears
(`linears.0..3` for q, k, v, out, tbsrn.py:116-119), which the JAX
package's porter concatenates into its fused qkv Dense.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from fudanocr_tpu_torch.nn.layers import linear


def positional_encoding_1d(d_model: int, length: int) -> np.ndarray:
    """[length, d_model] interleaved sin/cos encoding (host-side constant)."""
    pe = np.zeros((length, d_model), dtype=np.float32)
    position = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def positional_encoding_2d(d_model: int, height: int, width: int) -> np.ndarray:
    """[d_model, height, width]: first half sin/cos over width (x), second
    half over height (y)."""
    if d_model % 4 != 0:
        raise ValueError(f"2D PE needs d_model % 4 == 0, got {d_model}")
    pe = np.zeros((d_model, height, width), dtype=np.float32)
    half = d_model // 2
    div = np.exp(np.arange(0.0, half, 2, dtype=np.float32)
                 * -(math.log(10000.0) / half))
    pos_w = np.arange(width, dtype=np.float32)[:, None]
    pos_h = np.arange(height, dtype=np.float32)[:, None]
    pe[0:half:2, :, :] = np.sin(pos_w * div).T[:, None, :].repeat(height, 1)
    pe[1:half:2, :, :] = np.cos(pos_w * div).T[:, None, :].repeat(height, 1)
    pe[half::2, :, :] = np.sin(pos_h * div).T[:, :, None].repeat(width, 2)
    pe[half + 1::2, :, :] = np.cos(pos_h * div).T[:, :, None].repeat(width, 2)
    return pe


class MultiHeadAttention(nn.Module):
    """Self-attention over (B, L, D): per-head scaled dot product with fp32
    scores and softmax, probabilities rounded to the activation dtype before
    the value product, then the output linear (tbsrn.py:95-150)."""

    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % heads {num_heads} != 0")
        self.num_heads = num_heads
        self.linears = nn.ModuleList(nn.Linear(d_model, d_model)
                                     for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads
        q, k, v = (linear(m, x).view(b, l, h, d // h).transpose(1, 2)
                   for m in self.linears[:3])
        scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(d // h)
        probs = scores.softmax(-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, l, d)
        return linear(self.linears[3], out)
