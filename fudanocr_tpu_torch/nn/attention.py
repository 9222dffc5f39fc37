"""Multi-head attention and sinusoidal positional encodings (port of
fudanocr_tpu/nn/attention.py).

The encodings are host-side numpy constants copied from the JAX module
(which cannot be imported here: it pulls in jax). The attention keeps the
reference's four linears (`linears.0..3` for q, k, v, out, tbsrn.py:116-
119), which the JAX package's porter concatenates into its fused qkv (or
kv) Dense; self-attention concatenates them the same way at run time.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.core import mesh
from fudanocr_tpu_torch.nn.layers import dropout, linear
from fudanocr_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_WIDTH, UNMASKED_HEAD_WIDTHS, flash_attention_supported,
    flash_mha, flash_mha_qkv_packed, flash_mha_qkv_packed_dropout,
    flash_mha_qkv_packed_dropout_reference, flash_mha_qkv_packed_reference,
    flash_mha_reference, flash_packed_supported)


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
    """MHA over (B, L, D) with an optional boolean mask, cross-attention,
    attention-map output and dropout on the probabilities (port of the
    JAX module, reference tbsrn.py:95-150).

    Scores and softmax run in float32, the probabilities are rounded to
    the activation dtype before the value product. `kv_features` is the
    width of the key/value input when it differs from `d_model` (the
    oracle's cross-attention over 1024-wide conv tokens at reduced
    d_model).

    Routes, as in the JAX module (nn/attention.py:102-146): a module built
    with `use_flash=True` (TBSRN's enhancer), called without a mask, a map
    override or maps asked for, takes the attention kernels:
    self-attention at a shape `flash_packed_supported` takes runs off the
    fused [q|k|v] buffer, through `flash_mha_qkv_packed_dropout` (hash
    dropout, one uint32 seed drawn from `generator` per call, images keyed
    on their global index in a data-parallel step: `core/mesh.
    batch_offset`) in train mode with `dropout_rate > 0`, else through
    `flash_mha_qkv_packed`;
    otherwise, without train-mode dropout, a (B, H, L, dh) q that
    `flash_attention_supported` takes runs through `flash_mha`. Each
    route also needs a head width its kernel is built for (32 for the
    dropout kernels, 32 or 64 for the others; `flash_mha` also a key count
    that is a multiple of 64); JAX's gates admit more, and those shapes
    run plain. Everything else, and every call of a
    module without `use_flash`, runs the plain path, whose train-mode
    dropout draws its mask from `generator`. `kernels=False` runs each
    kernel's plain version on the same route (the comparison path).
    """

    def __init__(self, num_heads: int, d_model: int,
                 dropout_rate: float = 0.1,
                 kv_features: Optional[int] = None, kernels: bool = True,
                 use_flash: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % heads {num_heads} != 0")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.kernels = kernels
        self.use_flash = use_flash
        kv = kv_features or d_model
        self.linears = nn.ModuleList([
            nn.Linear(d_model, d_model), nn.Linear(kv, d_model),
            nn.Linear(kv, d_model), nn.Linear(d_model, d_model)])

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None,
                attention_map: Optional[torch.Tensor] = None,
                deterministic: bool = True, need_weights: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (out (B, Lq, D), probs (B, H, Lq, Lk) float32 or None).

        `mask` broadcasts to (B, 1, Lq, Lk), True = attend.
        `attention_map` replaces the probabilities. `generator` (on the
        activations' device; its default when None) feeds dropout."""
        h = self.num_heads
        b, lq = query.shape[0], query.shape[1]
        lk = key.shape[1]
        d = self.linears[0].out_features
        dk = d // h
        train_dropout = not deterministic and self.dropout_rate > 0.0
        flash = (self.use_flash and not need_weights and mask is None
                 and attention_map is None)
        if query is key and key is value:
            w = torch.cat([m.weight for m in self.linears[:3]])
            bias = torch.cat([m.bias for m in self.linears[:3]])
            qkv = F.linear(query, w.to(query.dtype), bias.to(query.dtype))
            if flash and flash_packed_supported(lq, lk, d, h):
                if train_dropout and dk == KERNEL_HEAD_WIDTH:
                    seed = torch.randint(0, 2 ** 32, (), generator=generator,
                                         dtype=torch.int64,
                                         device=qkv.device)
                    run = (flash_mha_qkv_packed_dropout if self.kernels
                           else flash_mha_qkv_packed_dropout_reference)
                    out = run(qkv, seed, h, self.dropout_rate,
                              mesh.batch_offset(b))
                    return linear(self.linears[3], out), None
                if not train_dropout and dk in UNMASKED_HEAD_WIDTHS:
                    run = (flash_mha_qkv_packed if self.kernels
                           else flash_mha_qkv_packed_reference)
                    return linear(self.linears[3], run(qkv, h)), None
            q, k, v = qkv.split(d, dim=-1)
        else:
            q, k, v = (linear(m, x) for m, x in
                       zip(self.linears[:3], (query, key, value)))
        q = q.reshape(b, lq, h, dk).transpose(1, 2)
        k = k.reshape(b, lk, h, dk).transpose(1, 2)
        v = v.reshape(b, lk, h, dk).transpose(1, 2)

        if attention_map is not None:
            probs = attention_map
        elif (flash and not train_dropout and dk in UNMASKED_HEAD_WIDTHS
              and lk % 64 == 0 and flash_attention_supported(q.shape)):
            run = flash_mha if self.kernels else flash_mha_reference
            out = run(q, k, v).transpose(1, 2).reshape(b, lq, d)
            return linear(self.linears[3], out), None
        else:
            scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(dk)
            if mask is not None:
                scores = scores.masked_fill(~mask, -1e30)
            probs = scores.softmax(-1)
            if train_dropout:
                probs = dropout(probs, self.dropout_rate, generator)
        out = (probs.to(v.dtype) @ v).transpose(1, 2).reshape(b, lq, d)
        out = linear(self.linears[3], out)
        return out, (probs if need_weights else None)
