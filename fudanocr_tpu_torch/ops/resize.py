"""torch-exact bicubic resize (port of fudanocr_tpu/ops/resize.py).

The reference feeds its CRNN evaluator through `F.interpolate(x, (32, 100),
mode='bicubic')` (scene-text-telescope/interfaces/base.py:319-325); the JAX
op rebuilds that kernel (a = -0.75, align_corners=False, no antialias) as
two interpolation matmuls. Here it is the operator itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bicubic_torch(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NHWC bicubic resize in float32 -> (B, h_out, w_out, C). Values may
    overshoot [0, 1], as torch's do (no clamping)."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(out_hw),
                      mode="bicubic", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
