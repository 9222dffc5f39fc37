"""STN localisation head predicting TPS control points (port of
fudanocr_tpu/nn/stn.py; reference scene-text-telescope/model/stn_head.py).

Six conv3x3+BN+ReLU blocks with interleaved max-pools collapse a
(B, C, 16, 64) image to (B, 256, 1, 2); fc+BN+ReLU embeds it and a
zero-weight fc whose bias is a near-border control-point grid emits the
points. Parameter names are the reference's (`stn_convnet.{0,2,..,10}`,
`stn_fc1.{0,1}`, `stn_fc2`).

The (256, 1, 2) map is flattened in (h, w, c) order, as the JAX package
does from its NHWC layout, so the two packages agree on the same weights.
The reference flattens NCHW in (c, h, w) order; that difference matters
where the STN runs, which is training (ROADMAP.md Queue C6: the port
follows the JAX package).

`forward(x, train=True)` runs every BatchNorm (the conv stack's and
`stn_fc1`'s) on batch statistics and updates their running statistics
the flax way (`nn.layers.batch_norm`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.nn.layers import ConvBNReLU, batch_norm, linear


def _init_ctrl_bias(num_ctrlpoints: int, margin: float = 0.01) -> np.ndarray:
    per_side = num_ctrlpoints // 2
    xs = np.linspace(margin, 1.0 - margin, per_side)
    top = np.stack([xs, np.full(per_side, margin)], axis=1)
    bottom = np.stack([xs, np.full(per_side, 1.0 - margin)], axis=1)
    return np.concatenate([top, bottom], axis=0).astype(np.float32).ravel()


class STNHead(nn.Module):
    def __init__(self, in_planes: int = 3, num_ctrlpoints: int = 20,
                 activation: str = "none"):
        super().__init__()
        self.num_ctrlpoints = num_ctrlpoints
        self.activation = activation
        layers = []
        feats = (32, 64, 128, 256, 256, 256)
        for i, f in enumerate(feats):
            layers.append(ConvBNReLU(in_planes if i == 0 else feats[i - 1], f))
            if i < 4:
                layers.append(nn.MaxPool2d(2))
            elif i == 4:
                layers.append(nn.MaxPool2d((1, 2)))
        self.stn_convnet = nn.Sequential(*layers)
        self.stn_fc1 = nn.Sequential(nn.Linear(2 * 256, 512),
                                     nn.BatchNorm1d(512), nn.ReLU())
        self.stn_fc2 = nn.Linear(512, num_ctrlpoints * 2)
        bias = _init_ctrl_bias(num_ctrlpoints)
        if activation == "sigmoid":
            bias = -np.log(1.0 / bias - 1.0)
        with torch.no_grad():
            self.stn_fc2.weight.zero_()
            self.stn_fc2.bias.copy_(torch.from_numpy(bias))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW (B, C, >=16, >=32) -> (embedding (B, 512), points (B, N, 2))."""
        if x.shape[2] < 16 or x.shape[3] < 32:
            raise ValueError(
                f"STNHead needs input of at least 16x32 (got "
                f"{x.shape[2]}x{x.shape[3]}): its five pooling stages reduce "
                f"height by 16x and width by 32x (stn_head.py:32-43)")
        for m in self.stn_convnet:
            x = m(x, train) if isinstance(m, ConvBNReLU) else m(x)
        x = x.permute(0, 2, 3, 1).flatten(1)
        img_feat = F.relu(batch_norm(self.stn_fc1[1],
                                     linear(self.stn_fc1[0], x), train))
        pts = linear(self.stn_fc2, 0.1 * img_feat)
        if self.activation == "sigmoid":
            pts = torch.sigmoid(pts)
        return img_feat, pts.view(-1, self.num_ctrlpoints, 2)
