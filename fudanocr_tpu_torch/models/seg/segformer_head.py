"""SegFormer decode head, eval (port of fudanocr_tpu/models/seg/
segformer_head.py; reference mmseg/models/decode_heads/segformer_head.py:
92-147): per scale a 1x1 conv + BN + ReLU, bilinear upsampling to the 1/4
scale, concat, a 1x1 fusion conv + BN + ReLU, and the 1x1 classifier
(dropout is the identity at eval).

NCHW in and out. Keys `convs.{i}.conv`, `convs.{i}.bn`, `fusion_conv.conv`,
`fusion_conv.bn`, `conv_seg`, which `utils/porters.port_segformer_head`
reads.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.models.seg.cascade_mit import upsample
from fudanocr_tpu_torch.nn.layers import batch_norm


class ConvBNReLU(nn.Module):
    """mmcv ConvModule: bias-free 1x1 conv, BatchNorm, ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn = nn.BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm(self.bn, self.conv(x)))


class SegformerHead(nn.Module):
    def __init__(self, in_features: Sequence[int], num_classes: int = 2,
                 channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(ConvBNReLU(c, channels)
                                   for c in in_features)
        self.fusion_conv = ConvBNReLU(channels * len(in_features), channels)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        ref = inputs[0]
        outs = [upsample(conv(x), ref) for conv, x in zip(self.convs, inputs)]
        return self.conv_seg(self.fusion_conv(torch.cat(outs, 1)))
