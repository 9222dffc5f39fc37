"""Segmentation datasets: the directory scan and the synthetic set, and
their static-size batches (port of fudanocr_tpu/data/seg_dataset.py;
mmseg/datasets/custom.py and the `_Det` datasets), without PIL.

A batch is a dict of stacked numpy arrays, "img" (B, H, W, 3) float32,
"gt_seg" (B, H, W) int32, "valid" (B,) float32 and, when every sample has
one, "gt_det" (B, H, W) int32. The batch size is static: the last partial
batch is padded by repeating its last sample and `valid` marks the
padding, so training shapes stay fixed and evaluation counts every sample
once.

`SyntheticTextSeg` draws its text from the port's bitmap glyphs
(`data/glyphs.py`), not PIL's default font: its random draws and its
pixels outside the text boxes equal the JAX set's; the glyphs, and so the
masks and det boxes, differ.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fudanocr_tpu_torch.data.glyphs import draw_text, text_bbox
from fudanocr_tpu_torch.data.seg_pipeline import Compose, Sample
from fudanocr_tpu_torch.data.workers import rows_of


def stack_batch(items: List[Sample], valid: np.ndarray) -> Dict:
    batch = {
        "img": np.stack([it["img"] for it in items]).astype(np.float32),
        "gt_seg": np.stack([it["gt_seg"] for it in items]).astype(np.int32),
        "valid": valid,
    }
    if all("gt_det" in it for it in items):
        batch["gt_det"] = np.stack(
            [it["gt_det"] for it in items]).astype(np.int32)
    return batch


def batches_from(getitem: Callable[[int], Sample], n: int, batch_size: int,
                 shuffle: bool, seed: int, drop_last: bool,
                 shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict]:
    """Batches of samples getitem(0..n-1), in order or shuffled by
    `random.Random(seed)` (the JAX module's order for the same seed).
    `shard=(k, n)` builds only rank k's rows of each padded batch
    (`data/workers.rows_of`), with their `valid` flags. A pipeline's random
    transforms draw from the process's `random` module in read order
    (unseeded in the apps, as in JAX's), so each rank draws its own."""
    order = list(range(n))
    if shuffle:
        random.Random(seed).shuffle(order)
    for s in range(0, n, batch_size):
        idxs = order[s:s + batch_size]
        if len(idxs) < batch_size and drop_last:
            break
        valid = np.zeros((batch_size,), np.float32)
        valid[:len(idxs)] = 1.0
        while len(idxs) < batch_size:  # pad by repeating the last sample
            idxs.append(idxs[-1])
        rows = rows_of(range(batch_size), shard)
        yield stack_batch([getitem(idxs[j]) for j in rows], valid[rows])


class SegDataset:
    """Scan `img_dir` for images (`img_suffix`), pair each with the
    annotation of the same name in `ann_dir` and, when `det_dir` holds
    one, the det mask; run the pipeline per item. `split` names a file of
    basenames to keep. A missing det mask leaves that sample without one
    (partial det coverage)."""

    def __init__(self, img_dir: str, ann_dir: str,
                 pipeline: Sequence, img_suffix: str = ".jpg",
                 seg_suffix: str = ".png",
                 det_dir: Optional[str] = None, det_suffix: str = ".png",
                 split: Optional[str] = None):
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        self.det_dir = det_dir
        self.pipeline = Compose(pipeline)
        names = sorted(
            f[:-len(img_suffix)] for f in os.listdir(img_dir)
            if f.endswith(img_suffix))
        if split:
            with open(split) as f:
                keep = {line.strip() for line in f}
            names = [n for n in names if n in keep]

        def det_path(n):
            if not det_dir:
                return None
            p = os.path.join(det_dir, n + det_suffix)
            return p if os.path.exists(p) else None

        self.samples = [
            (os.path.join(img_dir, n + img_suffix),
             os.path.join(ann_dir, n + seg_suffix),
             det_path(n))
            for n in names]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Sample:
        img_path, seg_path, det_path = self.samples[idx]
        sample = {"img_path": img_path, "seg_path": seg_path}
        if det_path:
            sample["det_path"] = det_path
        return self.pipeline(sample)

    builds_rows = True   # `batches(shard=)`: a data-parallel rank's rows

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = False,
                shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict]:
        return batches_from(self.__getitem__, len(self), batch_size,
                            shuffle, seed, drop_last, shard)


class SyntheticTextSeg:
    """Random 4-letter words on noisy backgrounds with exact masks, a
    stand-in for TextSeg/TotalText; `with_det` adds the det mask, each
    word's box filled (its right and bottom edges included, as PIL's
    `rectangle` fills them). Draws per item from
    `np.random.default_rng(seed * 9973 + idx)`, in the JAX set's order."""

    def __init__(self, num_samples: int = 32, size: Tuple[int, int] = (64, 64),
                 pipeline: Optional[Sequence] = None, seed: int = 0,
                 with_det: bool = False):
        self.num_samples = num_samples
        self.size = size
        self.pipeline = Compose(pipeline) if pipeline else None
        self.seed = seed
        self.with_det = with_det

    def __len__(self):
        return self.num_samples

    def draws(self, idx: int):
        """Item idx's random draws: (background RGB, [(origin (x, y),
        word, RGB)], noise (H, W, 3) float64)."""
        rng = np.random.default_rng(self.seed * 9973 + idx)
        h, w = self.size
        bg = tuple(int(v) for v in rng.integers(100, 255, 3))
        words = []
        for _ in range(int(rng.integers(1, 4))):
            x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
            text = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 4))
            color = tuple(int(v) for v in rng.integers(0, 80, 3))
            words.append(((x0, y0), text, color))
        return bg, words, rng.normal(0, 5, (h, w, 3))

    def __getitem__(self, idx: int) -> Sample:
        h, w = self.size
        bg, words, noise = self.draws(idx)
        img = np.empty((h, w, 3), np.uint8)
        img[:] = bg
        mask = np.zeros((h, w), np.uint8)
        det = np.zeros((h, w), np.uint8)
        for xy, text, color in words:
            draw_text(img, xy, text, color)
            draw_text(mask, xy, text, 1)
            x0, y0, x1, y1 = text_bbox(xy, text)
            det[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = 1
        arr = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
        sample = {"img": arr, "gt_seg": mask}
        if self.with_det:
            sample["gt_det"] = det
        if self.pipeline:
            sample = self.pipeline(sample)
        return sample

    builds_rows = True   # `batches(shard=)`: a data-parallel rank's rows

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = False,
                shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict]:
        return batches_from(self.__getitem__, len(self), batch_size,
                            shuffle, seed, drop_last, shard)
