"""Synthetic TextZoom-style dataset for tests, smoke training and benches
(port of fudanocr_tpu/data/synthetic.py), without PIL.

Random lowercase/digit strings on noisy grey backgrounds as (HR, LR,
label) triples with the TextZoom geometry, so every trainer and eval path
runs with no data on disk. Every random draw is the JAX class's, in its
order: the labels from `random.Random(seed)`; per item, from
`np.random.default_rng(seed * 100003 + idx)`, the background and text
grey, the text's x and y offsets, then the N(0, 6) noise. The LR image is
PIL's bicubic downsample of the HR, then PIL's GaussianBlur(0.6), both
byte-equal (`data/image.py`).

The one difference: the glyphs. JAX draws the text with PIL's default
font, a FreeType font with anti-aliasing; the port draws it from its own
fixed-width bitmap table (`data/glyphs.py`). Outside the text's box the
images equal JAX's byte for byte; inside it they differ.
"""

from __future__ import annotations

import random
import string
from typing import Tuple

import numpy as np

from fudanocr_tpu_torch.data.collate import sr_collate
from fudanocr_tpu_torch.data.glyphs import draw_text
from fudanocr_tpu_torch.data.image import gaussian_blur, resize_bicubic
from fudanocr_tpu_torch.data.workers import rows_of


class SyntheticTextZoom:
    """Deterministic synthetic paired SR dataset: items are (hr, lr,
    label), uint8 (H, W, 3) images; `hr_size` is (width, height)."""

    def __init__(self, num_samples: int = 256, seed: int = 0,
                 hr_size: Tuple[int, int] = (128, 32),
                 scale: int = 2, max_label_len: int = 8):
        self.num_samples = num_samples
        self.hr_size = hr_size
        self.scale = scale
        rng = random.Random(seed)
        alphabet = string.ascii_lowercase + string.digits
        self.labels = [
            "".join(rng.choice(alphabet)
                    for _ in range(rng.randint(3, max_label_len)))
            for _ in range(num_samples)
        ]
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def draws(self, idx: int):
        """Item idx's random draws: (bg grey, text grey, text origin (x,
        y), noise (H, W, 3) float64)."""
        rng = np.random.default_rng(self.seed * 100003 + idx)
        w, h = self.hr_size
        bg = int(rng.integers(120, 255))
        fg = int(rng.integers(0, 100))
        x = 4 + int(rng.integers(0, 8))
        y = 4 + int(rng.integers(0, 8))
        return bg, fg, (x, y), rng.normal(0, 6, (h, w, 3))

    def __getitem__(self, idx: int):
        label = self.labels[idx]
        bg, fg, xy, noise = self.draws(idx)
        w, h = self.hr_size
        img = np.full((h, w, 3), bg, np.uint8)
        draw_text(img, xy, label, fg)
        arr = np.clip(img.astype(np.float32) + noise, 0, 255)
        hr = arr.astype(np.uint8)
        lr = resize_bicubic(hr, (w // self.scale, h // self.scale))
        return hr, gaussian_blur(lr, 0.6), label

    def fetch_items(self, indices):
        return [self[i] for i in indices]

    def collate(self, items, **collate_kw):
        return sr_collate(items, **collate_kw)

    # `batches(shard=)` draws only a data-parallel rank's rows
    builds_rows = True

    def batches(self, batch_size: int, shard: Tuple[int, int] = (0, 1),
                **collate_kw):
        for start in range(0, len(self) - batch_size + 1, batch_size):
            yield self.collate(self.fetch_items(rows_of(
                range(start, start + batch_size), shard)), **collate_kw)
