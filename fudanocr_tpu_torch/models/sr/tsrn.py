"""TSRN, the TextZoom sequential-residual-block SR network (port of
fudanocr_tpu/models/sr/tsrn.py; reference scene-text-telescope/model/
tsrn.py:18-98, byte-identical in text-gestalt).

The trunk of TBSRN (`models/sr/common.SRGenerator`) with residual blocks
of two bidirectional spatial GRUs instead of the FeatureEnhancer: gru1
scans along H (the W columns folded into the batch) inside the residual
branch, gru2 scans along W over `x + residual`, and its output IS the
block output (tsrn.py:89-98).

`fused_gru=True` (JAX's flag, tsrn.py:60; off by default, as there)
runs each GRU (input projections and recurrence) at inference through the
bidirectional GRU kernel (`ops/fused_gru.fused_bigru_x`, two launches per
block) where its gate holds; training keeps torch's GRU (cuDNN) with
autograd, as the JAX module keeps its scan. `kernels=False` runs the
kernel's plain version wherever the kernel would run (the comparison
path).

`forward(x, train=True)` is the training path: with `stn=True` the STN
head predicts TPS control points on the LR input and the TPS warp
replaces it; every BatchNorm runs on batch statistics and moves its
running ones as flax does. Input and output are NHWC. Module names follow
the original state_dict (`block1.0/1`, `block{i+2}.conv1/bn1/conv2/bn2/
gru1.conv1/gru1.gru/gru2.*`, `block{n+2}.0/1`, `block{n+3}.{u}.conv`,
`block{n+3}.{n_up}`, `stn_head.*`), which `utils/porters.port_tsrn`
reads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fudanocr_tpu_torch.models.sr.common import SRGenerator
from fudanocr_tpu_torch.nn.layers import batch_norm, conv2d, mish
from fudanocr_tpu_torch.nn.recurrent import SpatialGRU


class RecurrentResidualBlock(nn.Module):
    """conv-BN-mish-conv-BN, gru1 along H, then gru2 along W over the
    residual sum (reference tsrn.py:79-98), NCHW in and out."""

    def __init__(self, channels: int, fuse_gru: bool = False,
                 kernels: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.gru1 = SpatialGRU(channels, "H", fuse=fuse_gru, kernels=kernels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.gru2 = SpatialGRU(channels, "W", fuse=fuse_gru, kernels=kernels)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        r = mish(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        r = batch_norm(self.bn2, conv2d(self.conv2, r), train)
        r = self.gru1(r.permute(0, 2, 3, 1), train)
        y = self.gru2(x.permute(0, 2, 3, 1) + r, train)
        return y.permute(0, 3, 1, 2)


class TSRN(SRGenerator):
    """TSRN on the shared trunk; `hidden_units` sets the trunk width
    (2 * hidden_units channels, hidden_units GRU units per direction)."""

    def __init__(self, scale_factor: int = 2, width: int = 128,
                 height: int = 32, stn: bool = False, srb_nums: int = 5,
                 mask: bool = False, hidden_units: int = 32,
                 fused_gru: bool = False, kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            lambda feats: RecurrentResidualBlock(feats, fuse_gru=fused_gru,
                                                 kernels=kernels),
            scale_factor, width, height, stn, srb_nums, mask, hidden_units,
            dtype)
        self.jax_porter = ("tsrn", dict(srb_nums=srb_nums,
                                        scale_factor=scale_factor, stn=stn))
