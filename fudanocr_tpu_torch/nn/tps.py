"""Thin-plate-spline spatial transformer (port of fudanocr_tpu/nn/tps.py;
reference scene-text-telescope/model/tps_spatial_transformer.py:54-112).

Everything data-independent (the (N+3, N+3) inverse TPS kernel and the
(H*W, N+3) target-coordinate representation) is built in numpy at
construction and kept as non-persistent buffers, so they move with the
module and stay out of its state_dict (the JAX module has no parameters
either). Per batch the work is two small matmuls and one bilinear
`F.grid_sample` (zeros padding, align_corners=False), which
fudanocr_tpu/ops/grid_sample.py replicates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _partial_repr(points_a: np.ndarray, points_b: np.ndarray) -> np.ndarray:
    """TPS radial basis phi(a, b) = 0.5 * r^2 * log(r^2), zero at r=0."""
    diff = points_a[:, None, :] - points_b[None, :, :]
    dist2 = (diff ** 2).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rep = 0.5 * dist2 * np.log(dist2)
    rep[~np.isfinite(rep)] = 0.0
    return rep.astype(np.float32)


def build_output_control_points(num_control_points: int,
                                margins: Tuple[float, float]) -> np.ndarray:
    """Two rows of control points along top/bottom borders (inset by
    margins)."""
    margin_x, margin_y = margins
    per_side = num_control_points // 2
    xs = np.linspace(margin_x, 1.0 - margin_x, per_side)
    top = np.stack([xs, np.full(per_side, margin_y)], axis=1)
    bottom = np.stack([xs, np.full(per_side, 1.0 - margin_y)], axis=1)
    return np.concatenate([top, bottom], axis=0).astype(np.float32)


class TPSSpatialTransformer(nn.Module):
    """Warp (B, H, W, C) images by the TPS fitted to predicted control
    points `ctrl_points` (B, N, 2), xy in [0, 1] image coordinates.
    Returns (rectified (B, h, w, C) at `output_size`, source sampling
    coordinates (B, h*w, 2))."""

    def __init__(self, output_size: Tuple[int, int],
                 num_control_points: int = 20,
                 margins: Tuple[float, float] = (0.05, 0.05)):
        super().__init__()
        n = num_control_points
        self.output_size = tuple(output_size)
        target_cp = build_output_control_points(n, margins)
        forward_kernel = np.zeros((n + 3, n + 3), dtype=np.float32)
        forward_kernel[:n, :n] = _partial_repr(target_cp, target_cp)
        forward_kernel[:n, n] = 1.0
        forward_kernel[n, :n] = 1.0
        forward_kernel[:n, n + 1:] = target_cp
        forward_kernel[n + 1:, :n] = target_cp.T
        inverse_kernel = np.linalg.inv(forward_kernel)

        h, w = self.output_size
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        coords = np.stack([xs.ravel() / (w - 1), ys.ravel() / (h - 1)],
                          axis=1).astype(np.float32)  # (HW, 2) in xy
        target_repr = np.concatenate(
            [_partial_repr(coords, target_cp),
             np.ones((h * w, 1), np.float32), coords], axis=1)  # (HW, N+3)
        self.register_buffer("inverse_kernel",
                             torch.from_numpy(inverse_kernel.astype(
                                 np.float32)), persistent=False)
        self.register_buffer("target_repr", torch.from_numpy(target_repr),
                             persistent=False)

    def forward(self, images: torch.Tensor, ctrl_points: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = ctrl_points.shape[0]
        h, w = self.output_size
        # the fit runs in float32 whatever the module's dtype, as in JAX
        y = F.pad(ctrl_points.float(), (0, 0, 0, 3))       # (B, N+3, 2)
        mapping = self.inverse_kernel.float() @ y
        source = self.target_repr.float() @ mapping         # (B, HW, 2)
        grid = source.reshape(b, h, w, 2).clamp(0.0, 1.0) * 2.0 - 1.0
        warped = F.grid_sample(images.permute(0, 3, 1, 2), grid.to(
            images.dtype), mode="bilinear", padding_mode="zeros",
            align_corners=False)
        return warped.permute(0, 2, 3, 1), source
