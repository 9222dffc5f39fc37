"""Cascade MixVisionTransformer backbone (port of
fudanocr_tpu/models/seg/cascade_mit.py; reference text-focused-Transformers/
mmseg/models/backbones/cascade_mit.py:40-524).

A 7x7/4 conv stem and three pairs of ResNet basic blocks make a pyramid
(d x [1, 2, 5, 8] channels at 1/4 .. 1/32); the SegFormer stages then run
top-down, coarsest first: each stage's output is upsampled to the next
finer level, refined by that level's stage, and fused with the pyramid
level by concat + 1x1 conv. A stage is a 3x3 patch embed, LayerNorm,
`num_layers` pre-LN encoder layers (efficient attention with spatial
reduction `sr_ratio` on K/V, then MixFFN) and a LayerNorm.

`EfficientAttention` takes the JAX module's routes (cascade_mit.py:
173-233). With a `region` (the det-guided branches of models/seg/
det_guided.py: a pair of fp32 id vectors) it runs the region-masked kernel
(`ops/region_attention.region_flash_mha`, B6) when `region_flash_supported`
holds, else plain matmuls with the materialised (B, 1, Lq, Lkv) additive
mask; a masked call never takes B7 or B5. Without one, the packed kernel
(`ops/region_attention.packed_flash_mha`, B7) when `packed_flash_supported`
holds, else the (B, H, L, dh) kernel (`ops/flash_attention.flash_mha`, B5)
when `_flash_ok` holds, else plain matmuls with an fp32
softmax. `kernels=False` takes the plain route everywhere (the comparison
path). On CPU tensors the kernel routes run their plain versions.

Internal layout NCHW (feature maps) and (B, H*W, C) row-major tokens (the
JAX package's NHWC reshape); `CascadeMiT.forward` takes and returns NCHW,
and `models/seg/encoder_decoder.EncoderDecoder` is the NHWC public
function. Module names are the reference's state_dict keys (`conv1`,
`bn1`, `layer{1,2,3}.{0,1}`, `layers.{i}.{0,1,2}`, `conv2`..`conv5`), which
`utils/porters.port_cascade_mit` reads.

`dtype` (default float32; bfloat16 is what the JAX package benchmarks) is
the activations' type, as the JAX modules' `dtype` field: parameters stay
float32, each module rounds its input to the dtype, and the rounding
points are flax's: every conv and linear rounds its operands and result
(`nn/layers.conv2d`, `linear`), LayerNorm and BatchNorm compute float32
statistics and round their result (`layer_norm`, `batch_norm`), the
attention scores are a product at the dtype taken to float32, softmax in
float32 with the probabilities rounded to v's dtype, GELU at the dtype,
and `upsample` is `jax.image.resize` at the dtype (`ops/resize.
resize_bilinear`: bf16 weights, each axis's product rounded).

The mode is an argument, as in the JAX modules: `forward(x, train=True,
generator=g)` normalises with batch statistics and moves the running ones
(flax BatchNorm, `nn/layers.batch_norm`) and applies drop-path with the
schedule rate * i / (total - 1) over the encoder layers (cascade_mit.py:
350-354), its per-sample draws from the `torch.Generator` g; `train=False` (the
default) uses the running statistics and no drop-path. The JAX stem's
space-to-depth rewrite (`StemConv4x`, used only in training) is a TPU
matrix-unit trick computing the same function, and is not ported: the stem
is a plain 7x7/4 conv.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.core import mesh
from fudanocr_tpu_torch.nn.layers import (batch_norm, conv2d, layer_norm,
                                          linear)
from fudanocr_tpu_torch.ops.flash_attention import flash_mha
from fudanocr_tpu_torch.ops.region_attention import (packed_flash_mha,
                                                     packed_flash_supported,
                                                     region_flash_mha,
                                                     region_flash_supported,
                                                     region_mask)
from fudanocr_tpu_torch.ops.resize import resize_bilinear

Region = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _flash_ok(q_shape, lk: int) -> bool:
    """The gate of the `flash_mha` route: the device-side condition of the
    JAX package's `_flash_ok` (fudanocr_tpu/models/seg/cascade_mit.py:
    35-44), without its bound for CPU interpret mode. `q_shape` is
    (B, H, Lq, dh)."""
    _, _, lq, hd = q_shape
    return (lq >= 512 and lq % 256 == 0 and (lq <= 1024 or lq % 1024 == 0)
            and lk >= 128 and lk % 128 == 0 and hd % 8 == 0 and hd <= 128)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major positions."""
    return x.flatten(2).transpose(1, 2)


def to_map(t: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], *hw)


def drop_path(x: torch.Tensor, rate: float, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth (cascade_mit.py:47-54): in training each sample of
    x is kept with probability 1 - rate and scaled by 1 / (1 - rate), else
    zeroed; the draws come from `generator` (on x's device), the global
    batch's in a data-parallel step (`core/mesh.global_rand`)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = mesh.global_rand(shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path_rates(rate: float, num_layers: Sequence[int]) -> List[float]:
    """The per-layer schedule rate * i / (total - 1) over all encoder
    layers (cascade_mit.py:350-354), cut into stages."""
    total = sum(num_layers)
    dpr = [rate * i / max(total - 1, 1) for i in range(total)]
    offs = [sum(num_layers[:i]) for i in range(len(num_layers))]
    return [dpr[o:o + n] for o, n in zip(offs, num_layers)]


def upsample(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` to ref's spatial size, at x's
    dtype (`ops/resize.resize_bilinear`)."""
    return resize_bilinear(x, tuple(ref.shape[-2:]))


class StemConv4x(nn.Conv2d):
    """The 7x7 stride-4 stem conv, padding 3 (keys `weight`, `bias`), at
    its input's dtype."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, 7, stride=4, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self, x)


class ResNetBlock(nn.Module):
    """Basic block with biased convs (cascade_mit.py:45-67): keys `conv1`,
    `bn1`, `conv2`, `bn2` and, when the stride or width changes,
    `shortcut.{0,1}`."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(features)
        self.shortcut = None
        if stride != 1 or in_features != features:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_features, features, 1, stride),
                nn.BatchNorm2d(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        y = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        y = batch_norm(self.bn2, conv2d(self.conv2, y), train)
        r = x
        if self.shortcut is not None:
            r = batch_norm(self.shortcut[1], conv2d(self.shortcut[0], x),
                           train)
        return F.relu(y + r)


def run_blocks(blocks: nn.Sequential, x: torch.Tensor,
               train: bool) -> torch.Tensor:
    """A Sequential of ResNet blocks, each in the given mode."""
    for block in blocks:
        x = block(x, train)
    return x


class _InProj(nn.Module):
    """nn.MultiheadAttention's parameters: `in_proj_weight` (3C, C) and
    `in_proj_bias` for q, k, v, and `out_proj`."""

    def __init__(self, c: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)
        nn.init.xavier_uniform_(self.in_proj_weight)


class EfficientAttention(nn.Module):
    """SegFormer attention with spatial reduction on K/V
    (cascade_mit.py:94-215) over (B, H*W, C) tokens: keys `attn.*`, and
    `sr`, `norm` when sr_ratio > 1."""

    def __init__(self, c: int, num_heads: int, sr_ratio: int = 1,
                 kernels: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.kernels = kernels
        self.attn = _InProj(c)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(c, c, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(c, eps=1e-6)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                region: Region = None) -> torch.Tensor:
        """`region`: (rq (B, Lq), rkv (B, Lkv)) ids; pairs with equal ids
        get -1e10 added to their score."""
        x = x.to(self.dtype)
        b, lq, c = x.shape
        nh = self.num_heads
        w = self.attn.in_proj_weight.to(x.dtype)
        bias = self.attn.in_proj_bias.to(x.dtype)
        if self.sr_ratio > 1:
            q = F.linear(x, w[:c], bias[:c])
            kv = to_tokens(conv2d(self.sr, to_map(x, hw)))
            kv = F.linear(layer_norm(self.norm, kv), w[c:], bias[c:])
            k, v = kv[..., :c], kv[..., c:]
        else:
            qkv = F.linear(x, w, bias)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        lkv = k.shape[1]

        mask = None
        if region is not None:
            rq, rkv = (r.float() for r in region)
            if self.kernels and region_flash_supported(lq, lkv, c, nh):
                o = region_flash_mha(q, k, v, rq.contiguous(),
                                     rkv.contiguous(), nh)
                return linear(self.attn.out_proj, o)
            mask = region_mask(rq, rkv)[:, None]
        elif self.kernels and packed_flash_supported(lq, lkv, c, nh):
            o = packed_flash_mha(q, k, v, nh)
            return linear(self.attn.out_proj, o)
        heads = lambda t: t.unflatten(-1, (nh, c // nh)).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)
        if (mask is None and self.kernels
                and _flash_ok(q.shape, lkv)):
            o = flash_mha(q, k, v)
        else:
            s = torch.matmul(q, k.transpose(-1, -2)).float()
            s = s / math.sqrt(c // nh)
            if mask is not None:
                s = s + mask
            o = torch.matmul(torch.softmax(s, -1).to(v.dtype), v)
        return linear(self.attn.out_proj,
                      o.transpose(1, 2).reshape(b, lq, c))


class MixFFN(nn.Module):
    """1x1 conv -> 3x3 depthwise -> GELU -> 1x1 conv (cascade_mit.py:40-92):
    keys `layers.{0,1,4}` (2 is the GELU, 3 the reference's dropout)."""

    def __init__(self, c: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.Sequential(
            nn.Conv2d(c, hidden, 1),
            nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden),
            nn.GELU(), nn.Identity(), nn.Conv2d(hidden, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1, pe_conv, _, _, fc2 = self.layers
        y = conv2d(pe_conv, conv2d(fc1, x.to(self.dtype)))
        return conv2d(fc2, F.gelu(y))


class TransformerEncoderLayer(nn.Module):
    """Pre-LN: x + drop_path(attn(norm1(x))), then
    + drop_path(ffn(norm2(x))), on tokens."""

    def __init__(self, c: int, num_heads: int, mlp_ratio: int = 4,
                 sr_ratio: int = 1, kernels: bool = True,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(c, eps=1e-6)
        self.attn = EfficientAttention(c, num_heads, sr_ratio, kernels,
                                       dtype)
        self.norm2 = nn.LayerNorm(c, eps=1e-6)
        self.ffn = MixFFN(c, c * mlp_ratio, dtype)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                region: Region = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.drop_path_rate
        x = x.to(self.dtype)
        y = self.attn(layer_norm(self.norm1, x), hw, region)
        x = x + drop_path(y, rate, train, generator)
        y = to_tokens(self.ffn(to_map(layer_norm(self.norm2, x), hw)))
        return x + drop_path(y, rate, train, generator)


class _PatchEmbed(nn.Module):
    def __init__(self, in_features: int, c: int):
        super().__init__()
        self.projection = nn.Conv2d(in_features, c, 3, 1, 1)
        self.norm = nn.LayerNorm(c, eps=1e-6)


class CascadeStage(nn.ModuleList):
    """One cascade level: [patch embed (3x3/1 + LN), encoder layers, LN]
    (keys `0.projection`, `0.norm`, `1.{j}.*`, `2`)."""

    def __init__(self, in_features: int, c: int, num_layers: int,
                 num_heads: int, sr_ratio: int, mlp_ratio: int = 4,
                 kernels: bool = True,
                 drop_path_rates: Sequence[float] = (),
                 dtype: torch.dtype = torch.float32):
        rates = list(drop_path_rates) + [0.0] * num_layers
        super().__init__([
            _PatchEmbed(in_features, c),
            nn.ModuleList(TransformerEncoderLayer(c, num_heads, mlp_ratio,
                                                  sr_ratio, kernels,
                                                  rates[j], dtype)
                          for j in range(num_layers)),
            nn.LayerNorm(c, eps=1e-6)])
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embed, layers, norm = self
        x = conv2d(embed.projection, x.to(self.dtype))
        hw = tuple(x.shape[-2:])
        t = layer_norm(embed.norm, to_tokens(x))
        for layer in layers:
            t = layer(t, hw, None, train, generator)
        return to_map(layer_norm(norm, t), hw)


class CascadeMiT(nn.Module):
    """Top-down cascade SegFormer backbone: NCHW image -> the 4-scale
    pyramid [(d, 1/4), (2d, 1/8), (5d, 1/16), (8d, 1/32)] for heads
    (1, 2, 5, 8), NCHW."""

    def __init__(self, embed_dims: int = 32,
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratio: int = 4, in_features: int = 3,
                 kernels: bool = True, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.jax_porter = ("cascade_mit", dict(
            embed_dims=embed_dims, num_layers=tuple(num_layers),
            num_heads=tuple(num_heads), sr_ratios=tuple(sr_ratios)))
        d, nh = embed_dims, tuple(num_heads)
        pyr = [d, d * nh[1], d * nh[2], d * nh[3]]
        dpr = drop_path_rates(drop_path_rate, num_layers)
        self.conv1 = StemConv4x(in_features, d)
        self.bn1 = nn.BatchNorm2d(d)
        for i in range(3):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                ResNetBlock(pyr[i], pyr[i + 1], 2, dtype),
                ResNetBlock(pyr[i + 1], pyr[i + 1], 1, dtype)))
        self.layers = nn.ModuleList(
            CascadeStage(d * nh[min(i + 1, 3)], d * nh[i], num_layers[i],
                         nh[i], sr_ratios[i], mlp_ratio, kernels, dpr[i],
                         dtype)
            for i in range(4))
        # conv2..conv5 fuse levels 4..1 (the JAX package's fuse4..fuse1)
        for i in range(4):
            lvl = 3 - i
            self.add_module(f"conv{2 + i}", nn.Conv2d(
                pyr[lvl] + d * nh[lvl], pyr[lvl], 1, bias=False))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        x1 = batch_norm(self.bn1, self.conv1(x.to(self.dtype)), train)
        x2 = run_blocks(self.layer1, x1, train)
        x3 = run_blocks(self.layer2, x2, train)
        x4 = run_blocks(self.layer3, x3, train)
        stage = lambda i, t: self.layers[i](t, train, generator)
        fuse = lambda i, parts: conv2d(getattr(self, f"conv{i}"),
                                       torch.cat(parts, 1))
        x4_ = fuse(2, [x4, stage(3, x4)])
        x3_ = fuse(3, [x3, stage(2, upsample(x4_, x3))])
        x2_ = fuse(4, [x2, stage(1, upsample(x3_, x2))])
        x1_ = fuse(5, [x1, stage(0, upsample(x2_, x1))])
        return [x1_, x2_, x3_, x4_]
