"""Shared pieces of the SR generators (port of
fudanocr_tpu/models/sr/common.py). NCHW inside; parameter names follow
the reference (scene-text-telescope/model/tsrn.py:35-39, 101-114)."""

from __future__ import annotations

import torch
from torch import nn

from fudanocr_tpu_torch.nn.layers import batch_norm, conv2d, mish, pixel_shuffle


class UpsampleBlock(nn.Module):
    """conv3x3 to C*r^2 -> pixel shuffle -> mish (the reference's
    UpsampleBLock, key `conv`)."""

    def __init__(self, features: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(features, features * scale ** 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(pixel_shuffle(conv2d(self.conv, x), self.scale))


class ConvBN(nn.Sequential):
    """conv3x3 + BatchNorm, the mid-trunk block (keys `0` and `1`, as the
    reference's nn.Sequential)."""

    def __init__(self, features: int):
        super().__init__(nn.Conv2d(features, features, 3, padding=1),
                         nn.BatchNorm2d(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return batch_norm(self[1], conv2d(self[0], x), train)
