"""OpenCV's 8-bit colour conversions in numpy, without cv2.

* `rgb_to_hsv_cv2(rgb)`: `cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)` on uint8.
  Integer arithmetic (color_hsv RGB2HSV_b): V = max, S = diff * sdiv[V],
  H from the sector of the max channel times hdiv[diff], the tables in
  12-bit fixed point, so H lies in [0, 180).
* `hsv_to_rgb_cv2(hsv)`: `cv2.COLOR_HSV2RGB` on uint8 (HSV2RGB_b): H times
  6/180, S and V times 1/255, the sector formula in float32 with its two
  terms 1 - s * h and 1 - s * (1 - h) fused (one rounding, a fused
  multiply-add), each channel times 255 made a byte. OpenCV converts each
  row in blocks of `lanes` pixels with its vector code, which truncates
  that last product, and the row's remaining width % lanes pixels with
  its scalar code, which rounds it half to even: one level apart on about
  three pixels in four. LANES is 32 for OpenCV's AVX2 build on this host;
  another vector width moves the line (ROADMAP Queue C18).
* `rgb_to_gray_cv2(rgb)`: `cv2.COLOR_RGB2GRAY` on uint8 in 15-bit fixed
  point, (R * 9798 + G * 19235 + B * 3735 + 2^14) >> 15. It is not PIL's
  luma (`image.to_gray`).

All three equal OpenCV 5.0.0's on this host on every input: every RGB
colour; every HSV byte triple both in a vector block and in a row's tail.

Everything is numpy on the host; nothing calls torch.
"""

from __future__ import annotations

import numpy as np

HSV_SHIFT = 12
LANES = 32          # pixels per vector block of cv2's HSV2RGB here
_I = np.arange(1, 256, dtype=np.float64)
# saturate_cast<int> of a double rounds half to even, as np.rint does
SDIV = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / _I)]).astype(
    np.int64)
HDIV180 = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6.0 * _I))]
                         ).astype(np.int64)


def _rgb(img: np.ndarray, what: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{what} takes uint8 (H, W, 3) images")
    return img.astype(np.int64)


def rgb_to_hsv_cv2(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> uint8 (H, W, 3) HSV, H in [0, 180)."""
    x = _rgb(rgb, "rgb_to_hsv_cv2")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * HDIV180[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


# the channels (b, g, r) of each sector, as indices into
# (v, v(1 - s), v(1 - s h), v(1 - s (1 - h)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb_cv2(hsv: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) HSV, H in [0, 180) -> uint8 (H, W, 3) RGB."""
    x = np.asarray(hsv)
    if x.dtype != np.uint8 or x.ndim != 3 or x.shape[2] != 3:
        raise ValueError("hsv_to_rgb_cv2 takes uint8 (H, W, 3) images")
    f32, f64 = np.float32, np.float64
    h = x[..., 0].astype(f32) * f32(6.0 / 180)
    s = x[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = x[..., 2].astype(f32) * f32(1.0 / 255.0)
    # H < 180 gives h < 6: no wrap; a byte of 180 or more wraps by 6
    h = np.where(h >= 6, h - f32(6), h)
    h = np.where(h >= 6, h - f32(6), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    # a product of two float32 is exact in float64: one rounding, as a fma
    fall = (1 - s.astype(f64) * h).astype(f32)
    rise = (1 - s.astype(f64) * (f32(1) - h)).astype(f32)
    tab = np.stack([v, v * (f32(1) - s), v * fall, v * rise], -1)
    idx = _SECTORS[sector]
    bgr = np.take_along_axis(tab, idx, axis=-1)
    gray = (s == 0)[..., None]
    bgr = np.where(gray, v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255.0)
    vector = np.arange(x.shape[1]) < x.shape[1] // LANES * LANES
    rgb = np.where(vector[None, :, None], np.trunc(rgb), np.rint(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def rgb_to_gray_cv2(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> uint8 (H, W), as cv2's RGB2GRAY."""
    x = _rgb(rgb, "rgb_to_gray_cv2")
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)
