"""Host-side image preprocessing and fixed-shape batching, and the
device-side half of the uint8 collate (port of
fudanocr_tpu/data/collate.py).

Images are uint8 (H, W, 3) numpy arrays (data/image.py decodes them); the
bicubic resize is byte-equal to PIL's, so the batches equal the JAX
package's. Everything but `normalize_uint8` is numpy only: it runs in
forked worker processes, which must not call torch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from fudanocr_tpu_torch.data.image import resize_bicubic, to_gray


def resize_normalize(img: np.ndarray, size: Tuple[int, int],
                     mask: bool = False,
                     dtype: type = np.float32) -> np.ndarray:
    """uint8 (H, W, 3) image -> (h, w, C) `dtype`; `size` is (w, h).

    dtype=float32: values in [0, 1]. dtype=uint8: raw 0..255 bytes, the
    `/ 255` deferred to the device (`normalize_uint8`). The mask channel
    is the gray image (PIL "L") thresholded at its mean, 255 where it is
    at or below, stored as 0/255 so one uniform `/ 255` recovers the float
    collate."""
    arr = resize_bicubic(img, size)
    if arr.ndim == 2:
        arr = arr[..., None]
    if mask:
        gray = to_gray(arr).astype(np.float32)
        thres = gray.mean()
        m = np.where(gray <= thres, np.uint8(255), np.uint8(0))[..., None]
        arr = np.concatenate([arr, m], axis=-1)
    if dtype == np.uint8:
        return arr
    return arr.astype(np.float32) / 255.0


def sr_collate(batch: Sequence, img_h: int = 32, img_w: int = 128,
               down_sample_scale: int = 2, mask: bool = False,
               synthetic_lr: bool = False, dtype: type = np.float32):
    """(hr, lr, label) triples -> (hr [B,H,W,C], lr [B,H/s,W/s,C], labels).

    With `synthetic_lr` the items are (hr, label) and the LR image is the
    bicubic downsample of the HR source (alignCollate_syn); otherwise the
    stored LR image is used (alignCollate_real)."""
    hr_size = (img_w, img_h)
    lr_size = (img_w // down_sample_scale, img_h // down_sample_scale)
    hrs, lrs, labels = [], [], []
    for item in batch:
        if synthetic_lr:
            hr_img, label = item
            lr_img = resize_bicubic(
                hr_img, (hr_img.shape[1] // down_sample_scale,
                         hr_img.shape[0] // down_sample_scale))
        else:
            hr_img, lr_img, label = item
        hrs.append(resize_normalize(hr_img, hr_size, mask, dtype))
        lrs.append(resize_normalize(lr_img, lr_size, mask, dtype))
        labels.append(label)
    return np.stack(hrs), np.stack(lrs), labels


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 0..255 -> float32 [0, 1] on x's device, bit-equal to the
    float32 host collate (the same `/ 255.0` on the same bytes)."""
    return x.float() / 255.0
