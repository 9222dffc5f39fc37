"""Resizes of the JAX package's models.

* `resize_bicubic_torch`: the torch-exact bicubic resize (port of
  fudanocr_tpu/ops/resize.py). The reference feeds its CRNN evaluator
  through `F.interpolate(x, (32, 100), mode='bicubic')` (scene-text-
  telescope/interfaces/base.py:319-325); the JAX op rebuilds that kernel
  (a = -0.75, align_corners=False, no antialias) as two interpolation
  matmuls. Here it is the operator itself.
* `resize_bilinear`: `jax.image.resize(x, shape, "bilinear")` (jax
  _src/image/scale.py `_scale_and_translate`), which the seg models use
  for every bilinear resize: half-pixel centres, and a triangle kernel
  stretched by the ratio when it shrinks (antialiasing). In float32 it is
  `F.interpolate(mode="bilinear", antialias=<shrinking>)`, equal to JAX's
  to fp32 rounding. In a narrower dtype JAX rounds its fp32 weight
  matrices to that dtype and contracts one axis after the other, rounding
  each product to the dtype; the port does the same with the same weight
  matrices, in the axis order XLA's einsum picks (the cheaper one, height
  first on a tie), which reproduces JAX's bf16 result bit for bit on the
  CPU.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bicubic_torch(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NHWC bicubic resize in float32 -> (B, h_out, w_out, C). Values may
    overshoot [0, 1], as torch's do (no clamping)."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(out_hw),
                      mode="bicubic", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=256)
def _weights(n_in: int, n_out: int, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """JAX's `compute_weight_mat` for the triangle kernel with antialias,
    translation 0, computed in float32 as JAX computes it, then rounded to
    `dtype` on `device`: (n_in, n_out), column j the weights of output
    j. Made outside inference mode, whatever the caller's: the cached
    matrix also serves later training forwards, and autograd cannot save
    an inference tensor for the backward."""
    with torch.inference_mode(False):
        return _weight_matrix(n_in, n_out).to(device=device, dtype=dtype)


def _weight_matrix(n_in: int, n_out: int) -> torch.Tensor:
    inv = 1.0 / (n_out / n_in)            # Python floats, as in JAX
    stretch = max(inv, 1.0)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
    w = torch.clamp(1 - (dist / stretch).abs(), min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones(())),
                    torch.zeros(()))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros(()))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW x -> (B, C, *size), as `jax.image.resize(..., "bilinear")`
    (antialiased when shrinking) computes it at x's dtype; see the module
    docstring."""
    h, w = x.shape[-2:]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    if x.dtype == torch.float32:
        return F.interpolate(x, size=(oh, ow), mode="bilinear",
                             align_corners=False,
                             antialias=oh < h or ow < w)

    def along_h(t):
        if oh == h:
            return t
        return torch.matmul(t.transpose(-1, -2), _weights(
            h, oh, t.dtype, t.device)).transpose(-1, -2)

    def along_w(t):
        if ow == w:
            return t
        return torch.matmul(t, _weights(w, ow, t.dtype, t.device))

    # XLA's contraction order: the cheaper path, height first on a tie
    h_first = h * w * oh + oh * w * ow <= h * w * ow + h * ow * oh
    return along_w(along_h(x)) if h_first else along_h(along_w(x))


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW x -> (B, C, *size), as `jax.image.resize(..., "nearest")`:
    output i of an axis reads input floor((i + 0.5) * in / out), computed
    in float32 as JAX computes it (torch's "nearest-exact" rule)."""
    for axis, n in ((2, size[0]), (3, size[1])):
        m = x.shape[axis]
        if m != n:
            src = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long()
            x = x.index_select(axis, src.to(x.device))
    return x
