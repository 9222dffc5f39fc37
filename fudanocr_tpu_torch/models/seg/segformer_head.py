"""SegFormer decode head (port of fudanocr_tpu/models/seg/
segformer_head.py; reference mmseg/models/decode_heads/segformer_head.py:
92-147): per scale a 1x1 conv + BN + ReLU, bilinear upsampling to the 1/4
scale, concat, a 1x1 fusion conv + BN + ReLU, dropout, and the 1x1
classifier. `forward(inputs, train=True, generator=g)` takes batch
statistics in the BNs (flax, `nn/layers.batch_norm`) and applies flax
`Dropout(dropout_ratio)` after the fusion (`nn/layers.dropout`, draws from
g); `train=False` uses the running statistics and no dropout. `dtype`
(default float32) is the activations' type, as the JAX head's field:
parameters stay float32, the inputs are rounded to it, and the logits
come out in it (see models/seg/cascade_mit.py for the rounding points).

NCHW in and out. Keys `convs.{i}.conv`, `convs.{i}.bn`, `fusion_conv.conv`,
`fusion_conv.bn`, `conv_seg`, which `utils/porters.port_segformer_head`
reads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.models.seg.cascade_mit import upsample
from fudanocr_tpu_torch.nn.layers import batch_norm, conv2d, dropout


class ConvBNReLU(nn.Module):
    """mmcv ConvModule: bias-free 1x1 conv, BatchNorm, ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn = nn.BatchNorm2d(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(batch_norm(self.bn, conv2d(self.conv, x), train))


class SegformerHead(nn.Module):
    def __init__(self, in_features: Sequence[int], num_classes: int = 2,
                 channels: int = 256, dropout_ratio: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout_ratio = dropout_ratio
        self.convs = nn.ModuleList(ConvBNReLU(c, channels)
                                   for c in in_features)
        self.fusion_conv = ConvBNReLU(channels * len(in_features), channels)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs: Sequence[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        ref = inputs[0]
        outs = [upsample(conv(x.to(self.dtype), train), ref)
                for conv, x in zip(self.convs, inputs)]
        out = self.fusion_conv(torch.cat(outs, 1), train)
        if train:
            out = dropout(out, self.dropout_ratio, generator)
        return conv2d(self.conv_seg, out)
