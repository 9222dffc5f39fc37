"""Image decoding and PIL's bicubic resize in numpy, without PIL.

`decode_image(buf)` picks the JPEG or PNG decoder by magic bytes and
returns uint8 (H, W, 3) RGB the way PIL's `.convert("RGB")` does: gray is
replicated, alpha dropped, palettes looked up. `resize_bicubic(arr, (w,
h))` is byte-equal to PIL's `Image.resize(size, Image.BICUBIC)` on uint8
images (Pillow's Resample.c): a = -0.5 cubic with its support widened by
the scale when shrinking (so shrinking antialiases), each output's window
normalised by its sequential sum, weights in fixed point with 22
fraction bits, the horizontal pass first into a uint8 image, then the
vertical pass. `to_gray` is PIL's RGB -> "L" (ITU-R 601-2 luma in PIL's
fixed point).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from fudanocr_tpu_torch.data.jpeg import decode_jpeg
from fudanocr_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from fudanocr_tpu_torch.data.png import decode_png

PRECISION_BITS = 32 - 8 - 2


def decode_image(buf: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> uint8 (H, W, 3) RGB; anything else raises."""
    if buf is None:
        raise ValueError("no image bytes (missing key)")
    buf = bytes(buf)
    if buf[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(buf)
    elif buf.startswith(PNG_SIGNATURE):
        img = decode_png(buf)
    else:
        raise ValueError(f"unknown image format (magic {buf[:8]!r})")
    c = img.shape[2]
    if c in (1, 2):                       # L / LA -> RGB
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> (H, W) uint8 as PIL's convert("L")."""
    x = rgb.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic_filter (a = -0.5), operation for operation."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1
    far = ((((x - 5) * x + 8) * x) - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc:
    -> (first input index (out,), fixed-point weights (out, ksize))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                 * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):                # the C loop's summation order
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return idx, k


def _pass(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    idx, k = _coeffs(arr.shape[axis], out_size)
    taps = np.take(arr, idx, axis=axis).astype(np.int64)
    # taps: axis -> (out, ksize); weights broadcast over the other axes
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = k.shape
    acc = (taps * k.reshape(shape)).sum(axis=axis + 1)
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> `size` = (width, height), as PIL's
    Image.resize(size, Image.BICUBIC)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError("resize_bicubic takes uint8 images")
    w, h = (int(s) for s in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize_bicubic: bad size {size}")
    out = arr
    if w != arr.shape[1]:
        out = _pass(out, w, 1)
    if h != arr.shape[0]:
        out = _pass(out, h, 0)
    return out.copy() if out is arr else out
