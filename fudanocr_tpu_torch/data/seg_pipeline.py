"""Segmentation data pipelines in numpy, without PIL or cv2 (port of
fudanocr_tpu/data/seg_pipeline.py; mmseg/datasets/pipelines/loading.py
and transforms.py).

Composable callables over a sample dict {"img": HxWx3 uint8, "gt_seg": HxW
uint8, ...}. Each equals the JAX transform on the same sample:
* loading decodes with data/image.py (JPEG and PNG byte-equal to PIL's);
  annotations are read as PIL opens them, unconverted (`decode_raw`): a
  palette or gray PNG gives its index values (H, W), an RGB one stays
  (H, W, 3) for `remap_icdar13`;
* `Resize` is PIL's BILINEAR for the image and NEAREST for the label maps
  (`resize_bilinear`, `resize_nearest`);
* `remap_icdar13` and `PhotoMetricDistortion` use cv2's 8-bit gray and
  HSV conversions (data/color.py), and the distortion computes in float32
  in JAX's order of operations, `% 180` on the hue included.

Randomness: each random transform takes `rng` and defaults to the module
`random`, as JAX's do, so the same `random.seed(s)` gives the same draws
in the same order.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from fudanocr_tpu_torch.data.color import (hsv_to_rgb_cv2, rgb_to_gray_cv2,
                                           rgb_to_hsv_cv2)
from fudanocr_tpu_torch.data.image import (read_image, resize_bilinear,
                                           resize_nearest)

Sample = Dict[str, np.ndarray]
SEG_FIELDS = ("gt_seg", "gt_det")


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample


class LoadImageFromFile:
    """sample["img_path"] -> sample["img"], uint8 (H, W, 3) RGB."""

    def __call__(self, sample: Sample) -> Sample:
        if "img" not in sample and "img_path" in sample:
            sample["img"] = read_image(sample["img_path"])
        return sample


class LoadAnnotations:
    """Load and remap the annotation map, and load the det mask when the
    sample has a `det_path` (every dataset's det rule is 255 -> 1).
    `remap` is a per-dataset value function (the REMAPS table)."""

    def __init__(self, remap: Optional[Callable] = None):
        self.remap = remap

    def __call__(self, sample: Sample) -> Sample:
        if "gt_seg" not in sample and "seg_path" in sample:
            sample["gt_seg"] = read_image(sample["seg_path"], raw=True)
        if self.remap is not None:
            sample["gt_seg"] = self.remap(np.asarray(sample["gt_seg"]))
        if "gt_det" not in sample and sample.get("det_path"):
            det = read_image(sample["det_path"], raw=True).squeeze()
            det = det.copy()
            det[det == 255] = 1
            sample["gt_det"] = det
        return sample


def remap_textseg(seg: np.ndarray) -> np.ndarray:
    """100 -> text, 200 -> background; 255 stays (ignore)."""
    out = seg.copy()
    out[seg == 100] = 1
    out[seg == 200] = 0
    return out


def remap_bts(seg: np.ndarray) -> np.ndarray:
    """255 -> 1, everything else unchanged."""
    out = seg.copy()
    out[seg == 255] = 1
    return out


def remap_totaltext(seg: np.ndarray) -> np.ndarray:
    """Gray threshold at 127."""
    return (seg > 127).astype(np.uint8)


def remap_icdar13(seg: np.ndarray) -> np.ndarray:
    """RGB annotation -> cv2 gray; 255 -> background, other > 0 -> text."""
    if seg.ndim == 3:
        seg = rgb_to_gray_cv2(seg)
    out = seg.copy()
    out[seg == 255] = 0
    out[(seg > 0) & (seg != 255)] = 1
    return out


def remap_mlt(seg: np.ndarray) -> np.ndarray:
    """No value remap."""
    return seg


# dataset name -> remap function (the reference's per-dataset loaders)
REMAPS = {
    "textseg": remap_textseg,
    "bts": remap_bts,
    "totaltext": remap_totaltext,
    "icdar13": remap_icdar13,
    "mlt": remap_mlt,
}


class Resize:
    """Ratio-range random resize. With `keep_ratio` (mmcv.imrescale) the
    sampled box (img_scale[0] * ratio, img_scale[1] * ratio) bounds the
    long and short edges and the image is rescaled by one factor; without
    it the image goes to (w, h) of the box directly."""

    def __init__(self, img_scale: Tuple[int, int],
                 ratio_range: Tuple[float, float] = (0.5, 2.0),
                 keep_ratio: bool = True,
                 rng: Optional[random.Random] = None):
        self.img_scale = img_scale
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.rng = rng or random

    def target_size(self, hw: Tuple[int, int], ratio: float
                    ) -> Tuple[int, int]:
        """(h, w) in -> (h', w') out for a sampled ratio."""
        sw = int(self.img_scale[0] * ratio)
        sh = int(self.img_scale[1] * ratio)
        if not self.keep_ratio:
            return max(sh, 1), max(sw, 1)
        h, w = hw
        long_edge, short_edge = max(sw, sh), min(sw, sh)
        f = min(long_edge / max(h, w), short_edge / min(h, w))
        # mmcv._scale_size rounding: int(dim * f + 0.5)
        return max(int(h * f + 0.5), 1), max(int(w * f + 0.5), 1)

    def __call__(self, sample: Sample) -> Sample:
        ratio = self.rng.uniform(*self.ratio_range)
        h, w = self.target_size(sample["img"].shape[:2], ratio)
        sample["img"] = resize_bilinear(sample["img"], (w, h))
        for key in SEG_FIELDS:
            if key in sample:
                sample[key] = resize_nearest(sample[key], (w, h))
        return sample


class RandomCrop:
    """A random crop of `crop_size` (h, w), drawn again (up to 10 times)
    while one class covers `cat_max_ratio` or more of its labels."""

    def __init__(self, crop_size: Tuple[int, int],
                 cat_max_ratio: float = 0.75,
                 ignore_index: int = 255,
                 rng: Optional[random.Random] = None):
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index
        self.rng = rng or random

    def _crop_box(self, shape):
        h, w = shape[:2]
        ch, cw = self.crop_size
        y = self.rng.randint(0, max(h - ch, 0))
        x = self.rng.randint(0, max(w - cw, 0))
        return y, x

    def __call__(self, sample: Sample) -> Sample:
        ch, cw = self.crop_size
        img, seg = sample["img"], sample.get("gt_seg")
        for _ in range(10):
            y, x = self._crop_box(img.shape)
            crop_seg = None if seg is None else seg[y:y + ch, x:x + cw]
            if seg is None or self.cat_max_ratio >= 1.0:
                break
            labels, counts = np.unique(crop_seg, return_counts=True)
            counts = counts[labels != self.ignore_index]
            if len(counts) > 1 and counts.max() / counts.sum() \
                    < self.cat_max_ratio:
                break
        sample["img"] = img[y:y + ch, x:x + cw]
        for key in SEG_FIELDS:
            if key in sample:
                sample[key] = sample[key][y:y + ch, x:x + cw]
        return sample


class RandomFlip:
    def __init__(self, prob: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.prob = prob
        self.rng = rng or random

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() < self.prob:
            sample["img"] = sample["img"][:, ::-1].copy()
            for key in SEG_FIELDS:
                if key in sample:
                    sample[key] = sample[key][:, ::-1].copy()
        return sample


class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter: each applies with
    probability 1/2, and a mode coin puts contrast before (mode 1) or
    after (mode 0) the saturation/hue pair, which runs in cv2's 8-bit HSV
    (H in [0, 180))."""

    def __init__(self, brightness_delta: int = 32,
                 contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                 hue_delta: int = 18, rng: Optional[random.Random] = None):
        self.bd = brightness_delta
        self.cr = contrast_range
        self.sr = saturation_range
        self.hd = hue_delta
        self.rng = rng or random

    def _contrast(self, img):
        if self.rng.random() < 0.5:
            img = img * self.rng.uniform(*self.cr)
        return img

    def __call__(self, sample: Sample) -> Sample:
        img = sample["img"].astype(np.float32)
        if self.rng.random() < 0.5:          # brightness
            img = img + self.rng.uniform(-self.bd, self.bd)
        mode = self.rng.random() < 0.5
        if mode:
            img = self._contrast(img)
        if self.rng.random() < 0.5:          # saturation and hue
            hsv = rgb_to_hsv_cv2(np.clip(img, 0, 255).astype(np.uint8)
                                 ).astype(np.float32)
            hsv[..., 1] *= self.rng.uniform(*self.sr)
            hsv[..., 0] = (hsv[..., 0]
                           + self.rng.uniform(-self.hd, self.hd)) % 180
            img = hsv_to_rgb_cv2(np.clip(hsv, 0, 255).astype(np.uint8)
                                 ).astype(np.float32)
        if not mode:
            img = self._contrast(img)
        sample["img"] = np.clip(img, 0, 255).astype(np.uint8)
        return sample


class Normalize:
    """(img - mean) / std per channel, float32 (ImageNet RGB statistics)."""

    def __init__(self, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: Sample) -> Sample:
        sample["img"] = ((sample["img"].astype(np.float32) - self.mean)
                         / self.std)
        return sample


class Pad:
    """Pad bottom and right to at least `size` (h, w): the image with
    `pad_val`, the label maps with `seg_pad_val` (0 counts padding as
    background, 255 ignores it)."""

    def __init__(self, size: Tuple[int, int], pad_val: float = 0,
                 seg_pad_val: int = 0):
        self.size = size
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def __call__(self, sample: Sample) -> Sample:
        h, w = sample["img"].shape[:2]
        ph = max(self.size[0] - h, 0)
        pw = max(self.size[1] - w, 0)
        if ph or pw:
            sample["img"] = np.pad(sample["img"],
                                   ((0, ph), (0, pw), (0, 0)),
                                   constant_values=self.pad_val)
            for key in SEG_FIELDS:
                if key in sample:
                    sample[key] = np.pad(
                        sample[key], ((0, ph), (0, pw)),
                        constant_values=self.seg_pad_val)
        return sample
