"""Image decoding and PIL's image operations in numpy, without PIL.

`decode_image(buf)` picks the JPEG or PNG decoder by magic bytes and
returns uint8 (H, W, 3) RGB the way PIL's `.convert("RGB")` does: gray is
replicated, alpha dropped, palettes looked up. `decode_raw(buf)` returns
the array `np.asarray(Image.open(...))` gives, unconverted: (H, W) for
gray and palette images (the palette's indices), (H, W, C) otherwise.

Each operation below is byte-equal to PIL's on uint8 images:
* `resize_bicubic` / `resize_bilinear(arr, (w, h))`: `Image.resize(size,
  BICUBIC / BILINEAR)` (Pillow's Resample.c): the a = -0.5 cubic or the
  triangle, its support widened by the scale when shrinking (so shrinking
  antialiases), each output's window normalised by its sequential sum,
  weights in fixed point with 22 fraction bits, the horizontal pass first
  into a uint8 image, then the vertical pass;
* `resize_nearest`: `Image.resize(size, NEAREST)`, which Pillow runs as an
  affine scale: the source coordinate of output x is (x + 0.5) * in / out,
  accumulated one step at a time in doubles, then truncated;
* `gaussian_blur(img, radius)`: `ImageFilter.GaussianBlur(radius)`, three
  extended box blurs per axis (BoxBlur.c): an integer box radius plus a
  fractional weight for the two pixels beyond it, in 24-bit fixed point,
  each pass rounded to uint8, the horizontal passes first; edges repeat
  the border pixel. It is not a true Gaussian;
* `to_gray`: RGB -> "L" (ITU-R 601-2 luma in PIL's fixed point).
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


def decode_raw(buf: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> the uint8 array PIL's `np.asarray(Image.open)`
    gives without a conversion: a palette image keeps its indices, one
    channel comes back (H, W); anything else raises."""
    if buf is None:
        raise ValueError("no image bytes (missing key)")
    buf = bytes(buf)
    if buf[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(buf)
    elif buf.startswith(PNG_SIGNATURE):
        img = decode_png(buf, expand_palette=False)
    else:
        raise ValueError(f"unknown image format (magic {buf[:8]!r})")
    return img[..., 0] if img.shape[2] == 1 else img


def read_image(path: str, raw: bool = False) -> np.ndarray:
    """The file at `path` through `decode_image`, or `decode_raw`."""
    with open(path, "rb") as f:
        buf = f.read()
    return decode_raw(buf) if raw else decode_image(buf)


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


def _triangle(x: np.ndarray) -> np.ndarray:
    """Resample.c's bilinear_filter."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# Resample.c's filters: (function, support)
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_triangle, 1.0)}


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int, kind: str = "bicubic"):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the
    filter `kind` -> (input index (out, ksize), fixed-point weights (out,
    ksize))."""
    fn, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
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


def _pass(arr: np.ndarray, out_size: int, axis: int,
          kind: str) -> np.ndarray:
    idx, k = _coeffs(arr.shape[axis], out_size, kind)
    taps = np.take(arr, idx, axis=axis).astype(np.int64)
    # taps: axis -> (out, ksize); weights broadcast over the other axes
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = k.shape
    acc = (taps * k.reshape(shape)).sum(axis=axis + 1)
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _check(arr: np.ndarray, size, what: str) -> Tuple[int, int]:
    if arr.dtype != np.uint8:
        raise ValueError(f"{what} takes uint8 images")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"{what}: bad size {size}")
    return w, h


def _resample(arr: np.ndarray, size, kind: str) -> np.ndarray:
    arr = np.asarray(arr)
    w, h = _check(arr, size, f"resize_{kind}")
    out = arr
    if w != arr.shape[1]:
        out = _pass(out, w, 1, kind)
    if h != arr.shape[0]:
        out = _pass(out, h, 0, kind)
    return out.copy() if out is arr else out


def resize_bicubic(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> `size` = (width, height), as PIL's
    Image.resize(size, Image.BICUBIC)."""
    return _resample(arr, size, "bicubic")


def resize_bilinear(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> `size` = (width, height), as PIL's
    Image.resize(size, Image.BILINEAR)."""
    return _resample(arr, size, "bilinear")


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Geometry.c's ImagingScaleAffine: the coordinate starts at half a
    step and grows by one step per output pixel, summed in doubles."""
    step = in_size / out_size
    coord = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1,
                                                            step)]))
    return np.minimum(coord.astype(np.int64), in_size - 1)


def resize_nearest(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> `size` = (width, height), as PIL's
    Image.resize(size, Image.NEAREST)."""
    arr = np.asarray(arr)
    w, h = _check(arr, size, "resize_nearest")
    rows = _nearest_index(arr.shape[0], h)
    cols = _nearest_index(arr.shape[1], w)
    return np.ascontiguousarray(arr[rows][:, cols])


def _box_radius(radius: float, passes: int) -> np.float32:
    """BoxBlur.c's _gaussian_blur_radius: the extended box's radius for
    `passes` boxes of the Gaussian's variance, in C's float arithmetic."""
    f32 = np.float32
    sigma2 = f32(radius) * f32(radius) / f32(passes)
    big_l = f32(np.sqrt(12.0 * np.float64(sigma2) + 1.0))
    small_l = f32(np.floor((np.float64(big_l) - 1.0) / 2.0))
    a = (f32(2) * small_l + f32(1)) * (small_l * (small_l + f32(1))
                                       - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (small_l + f32(1)) * (small_l + f32(1))))
    return f32(small_l + a)


def _box_pass(arr: np.ndarray, radius: np.float32, axis: int) -> np.ndarray:
    """One of BoxBlur.c's line blurs along `axis`: the sum over the box of
    2r + 1 pixels times ww, plus the two pixels just beyond it times fw,
    indices clamped to the line, rounded from 24 fraction bits."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = arr.shape[axis]
    pos = np.arange(n)
    acc = 0
    for d in range(-r, r + 1):
        acc = acc + np.take(arr, np.clip(pos + d, 0, n - 1),
                            axis=axis).astype(np.int64)
    far = (np.take(arr, np.clip(pos - r - 1, 0, n - 1), axis=axis)
           .astype(np.int64)
           + np.take(arr, np.clip(pos + r + 1, 0, n - 1), axis=axis))
    return ((acc * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(arr: np.ndarray, radius: float) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> the same shape, as PIL's
    `img.filter(ImageFilter.GaussianBlur(radius))` (three box passes per
    axis)."""
    passes = 3
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError("gaussian_blur takes uint8 images")
    if radius < 0:
        raise ValueError(f"gaussian_blur: negative radius {radius}")
    r = _box_radius(radius, passes)
    out = arr.copy()
    if r == 0:
        return out
    for axis in (1, 0):
        for _ in range(passes):
            out = _box_pass(out, r, axis)
    return out
