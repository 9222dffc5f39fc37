"""Segmentation necks (port of fudanocr_tpu/models/seg/necks.py;
reference text-focused-Transformers/mmseg/models/necks/*.py): FPN,
MultiLevelNeck, JPU, MLANeck and ICNet's CascadeFeatureFusion / ICNeck.
No textformer config inserts one; they are ported with the JAX package's
inventory.

Lists of NCHW maps in and out, the JAX modules' semantics (bilinear and
nearest resizes are `jax.image.resize`'s, `ops/resize.py`), mmseg's
state_dict keys (which `utils/porters.port_<neck>` reads): mmcv
ConvModules `{name}.conv` (+ `{name}.bn`), biased without a norm.
`dtype` (default float32) is the activations' type, as the JAX modules'
field: parameters stay float32, each neck rounds its inputs to it, and
convs and BatchNorms follow the rounding points of models/seg/
cascade_mit.py. `forward(inputs, train=True)` takes batch statistics in
the BatchNorms (flax, `nn/layers.batch_norm`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.nn.layers import batch_norm, conv2d, layer_norm
from fudanocr_tpu_torch.ops.resize import resize_bilinear, resize_nearest

Maps = List[torch.Tensor]


class ConvModule(nn.Module):
    """mmcv ConvModule: conv (padding dilation * (kernel - 1) / 2, no bias
    before a norm), then BatchNorm and ReLU where asked (necks.py
    `_ConvBNReLU`, or a bare biased `nn.Conv`)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 dilation: int = 1, groups: int = 1, norm: bool = True,
                 relu: bool = True):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.conv = nn.Conv2d(in_features, features, kernel, 1, pad,
                              dilation, groups, bias=not norm)
        self.bn = nn.BatchNorm2d(features) if norm else None
        self.relu = relu

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv2d(self.conv, x)
        if self.bn is not None:
            y = batch_norm(self.bn, y, train)
        return F.relu(y) if self.relu else y


def _size(t: torch.Tensor) -> Tuple[int, int]:
    return tuple(t.shape[-2:])


class FPN(nn.Module):
    """Lateral 1x1 convs, a top-down pathway of nearest-upsampled sums, a
    3x3 conv per level (necks/fpn.py); keys `lateral_convs.{i}`,
    `fpn_convs.{i}`."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, norm=False, relu=False)
            for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, norm=False, relu=False)
            for _ in in_channels)

    def forward(self, inputs: Maps, train: bool = False) -> Maps:
        lat = [conv(x.to(self.dtype))
               for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_nearest(lat[i],
                                                     _size(lat[i - 1]))
        return [conv(t) for conv, t in zip(self.fpn_convs, lat)]


class MultiLevelNeck(nn.Module):
    """Per level a 1x1 projection, a bilinear rescale by `scales[i]` and a
    3x3 conv (necks/multilevel_neck.py); keys `lateral_convs.{i}`,
    `convs.{i}`."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 scales: Sequence[float] = (0.5, 1, 2, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scales = tuple(scales)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, norm=False, relu=False)
            for c in in_channels)
        self.convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, norm=False, relu=False)
            for _ in in_channels)

    def forward(self, inputs: Maps, train: bool = False) -> Maps:
        outs = []
        for i, x in enumerate(inputs):
            y = self.lateral_convs[i](x.to(self.dtype))
            s = self.scales[i] if i < len(self.scales) else 1
            if s != 1:
                h, w = _size(y)
                y = resize_bilinear(y, (int(h * s), int(w * s)))
            outs.append(self.convs[i](y))
        return outs


class _DepthwiseSeparable(nn.Module):
    """mmcv DepthwiseSeparableConvModule as JPU builds it: a dilated
    depthwise 3x3 conv + BN, then a 1x1 conv + BN + ReLU."""

    def __init__(self, in_features: int, features: int, dilation: int):
        super().__init__()
        self.depthwise_conv = ConvModule(in_features, in_features, 3,
                                         dilation, groups=in_features,
                                         relu=False)
        self.pointwise_conv = ConvModule(in_features, features, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x, train), train)


class JPU(nn.Module):
    """FastFCN's joint pyramid upsampling (necks/jpu.py:12-131): each level
    through a 3x3 conv + BN + ReLU to `mid_channels`, upsampled to the
    finest, concatenated, then one depthwise-separable dilated conv per
    dilation, concatenated; returns the inputs but the last, then that
    concatenation. Keys `conv_layers.{i}.0`, `dilation_layers.{i}.0.
    {depthwise_conv,pointwise_conv}`."""

    def __init__(self, in_channels: Sequence[int], mid_channels: int = 512,
                 dilations: Sequence[int] = (1, 2, 4, 8),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_layers = nn.ModuleList(
            nn.Sequential(ConvModule(c, mid_channels, 3))
            for c in in_channels)
        cat = mid_channels * len(in_channels)
        self.dilation_layers = nn.ModuleList(
            nn.Sequential(_DepthwiseSeparable(cat, mid_channels, d))
            for d in dilations)

    def forward(self, inputs: Maps, train: bool = False) -> Maps:
        feats = [conv[0](x.to(self.dtype), train)
                 for conv, x in zip(self.conv_layers, inputs)]
        feats = [feats[0]] + [resize_bilinear(f, _size(feats[0]))
                              for f in feats[1:]]
        feat = torch.cat(feats, 1)
        concat = torch.cat([layer[0](feat, train)
                            for layer in self.dilation_layers], 1)
        return list(inputs[:-1]) + [concat]


class MLANeck(nn.Module):
    """SETR's multi-level aggregation (necks/mla_neck.py): per level a
    LayerNorm over channels and a 1x1 conv + BN + ReLU, sums accumulated
    from the last level, a 3x3 conv + BN + ReLU on each. Keys `norm.{i}`,
    `mla.channel_proj.{i}`, `mla.feat_extract.{i}`."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.ModuleList(nn.LayerNorm(c, eps=1e-6)
                                  for c in in_channels)
        self.mla = nn.Module()
        self.mla.channel_proj = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in in_channels)
        self.mla.feat_extract = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3) for _ in in_channels)

    def forward(self, inputs: Maps, train: bool = False) -> Maps:
        proj = []
        for norm, conv, x in zip(self.norm, self.mla.channel_proj, inputs):
            x = layer_norm(norm, x.to(self.dtype).permute(0, 2, 3, 1))
            proj.append(conv(x.permute(0, 3, 1, 2), train))
        mids = []
        for feat in proj[::-1]:
            mids.append(feat if not mids else mids[-1] + feat)
        return [conv(m, train)
                for conv, m in zip(self.mla.feat_extract, mids)]


class CascadeFeatureFusion(nn.Module):
    """ICNet's CFF unit (necks/ic_neck.py:8-75): x_low upsampled to x_high,
    a 3x3 dilation-2 conv + BN on it, a 1x1 conv + BN on x_high, summed,
    ReLU. Returns (fused, x_low after its conv). Keys `conv_low`,
    `conv_high`."""

    def __init__(self, low_channels: int, high_channels: int,
                 out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_low = ConvModule(low_channels, out_channels, 3, 2,
                                   relu=False)
        self.conv_high = ConvModule(high_channels, out_channels, 1,
                                    relu=False)

    def forward(self, x_low: torch.Tensor, x_high: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        x_high = x_high.to(self.dtype)
        x_low = resize_bilinear(x_low.to(self.dtype), _size(x_high))
        x_low = self.conv_low(x_low, train)
        return F.relu(x_low + self.conv_high(x_high, train)), x_low


class ICNeck(nn.Module):
    """ICNet's neck (necks/ic_neck.py:78-148) over the 3-level pyramid
    (x_sub1, x_sub2, x_sub4): two cascade fusions; returns [x_24, x_12,
    the decode map] as the reference does. Keys `cff_24`, `cff_12`."""

    def __init__(self, in_channels: Sequence[int] = (64, 256, 256),
                 out_channels: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, c2, c4 = in_channels
        self.cff_24 = CascadeFeatureFusion(c4, c2, out_channels, dtype)
        self.cff_12 = CascadeFeatureFusion(out_channels, c1, out_channels,
                                           dtype)

    def forward(self, inputs: Maps, train: bool = False) -> Maps:
        x_sub1, x_sub2, x_sub4 = inputs
        x_cff_24, x_24 = self.cff_24(x_sub4, x_sub2, train)
        x_cff_12, x_12 = self.cff_12(x_cff_24, x_sub1, train)
        return [x_24, x_12, x_cff_12]
