"""Segmentation test-time transforms (port of the numpy `Normalize` and
`Pad` of fudanocr_tpu/data/seg_pipeline.py:256-295).

Callables over a sample dict {"img": HxWx3, "gt_seg": HxW, ...}, numpy
only: the JAX module imports PIL, which the machine with the card lacks,
and the rest of it (loading, training augmentation) belongs to the seg
training slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Sample = Dict[str, np.ndarray]
SEG_FIELDS = ("gt_seg", "gt_det")


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
