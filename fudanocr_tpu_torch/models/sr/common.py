"""Shared pieces of the SR generators (port of
fudanocr_tpu/models/sr/common.py). NCHW inside; parameter names follow
the reference (scene-text-telescope/model/tsrn.py:35-39, 101-114)."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from fudanocr_tpu_torch.nn.layers import (PReLU, batch_norm, conv2d, mish,
                                          pixel_shuffle)
from fudanocr_tpu_torch.nn.stn import STNHead
from fudanocr_tpu_torch.nn.tps import TPSSpatialTransformer


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


class SRGenerator(nn.Module):
    """The trunk TBSRN and TSRN share (reference tsrn.py:18-98,
    tbsrn.py:166-226): a 9x9 conv stem + PReLU (`block1`), `srb_nums`
    residual blocks made by `make_block(features)` (`block2` ..), a
    conv+BN tail with a global skip from the stem (`block{n+2}`),
    PixelShuffle upsampling and a 9x9 output conv (`block{n+3}`), tanh;
    with `stn`, the STN head and the TPS warp that replace the LR input
    in training (`stn_head`; the TPS holds no parameters).

    `width` x `height` is the HR size; at inference any LR geometry runs,
    in training the TPS warp outputs the LR size (height, width) /
    scale_factor. Input and output are NHWC, as in the JAX package; the
    convolutions run on an NCHW view of it."""

    def __init__(self, make_block: Callable[[int], nn.Module],
                 scale_factor: int, width: int, height: int, stn: bool,
                 srb_nums: int, mask: bool, hidden_units: int,
                 dtype: torch.dtype):
        super().__init__()
        self.width, self.height = width, height
        if not math.log2(scale_factor).is_integer():
            raise ValueError(f"scale_factor must be a power of 2, got "
                             f"{scale_factor}")
        in_planes = 4 if mask else 3
        feats = 2 * hidden_units
        self.srb_nums, self.dtype = srb_nums, dtype
        n_up = int(math.log2(scale_factor))
        self.block1 = nn.Sequential(
            nn.Conv2d(in_planes, feats, 9, padding=4), PReLU())
        for i in range(srb_nums):
            setattr(self, f"block{i + 2}", make_block(feats))
        setattr(self, f"block{srb_nums + 2}", ConvBN(feats))
        setattr(self, f"block{srb_nums + 3}", nn.Sequential(
            *[UpsampleBlock(feats, 2) for _ in range(n_up)],
            nn.Conv2d(feats, in_planes, 9, padding=4)))
        self.stn_head = (STNHead(in_planes, num_ctrlpoints=20)
                         if stn else None)
        self.tps = (TPSSpatialTransformer(
            (height // scale_factor, width // scale_factor),
            num_control_points=20, margins=(0.05, 0.05)) if stn else None)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) LR images in [0, 1] -> (B, sH, sW, C) SR in [-1, 1],
        at the model's compute dtype. `train=True` runs the training path
        (it updates the BatchNorm running statistics in place); dropout
        draws from `generator`, a torch.Generator on x's device."""
        if train and self.stn_head is not None:
            _, ctrl = self.stn_head(x.permute(0, 3, 1, 2).to(self.dtype),
                                    train=True)
            x, _ = self.tps(x, ctrl)
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        stem = self.block1[1](conv2d(self.block1[0], x))
        h = stem
        for i in range(self.srb_nums):
            h = getattr(self, f"block{i + 2}")(h, train, generator)
        h = stem + getattr(self, f"block{self.srb_nums + 2}")(h, train)
        head = getattr(self, f"block{self.srb_nums + 3}")
        for up in head[:-1]:
            h = up(h)
        h = torch.tanh(conv2d(head[-1], h))
        return h.permute(0, 2, 3, 1)
