"""Recognition datasets: LMDB char/text images and a synthetic generator
(port of fudanocr_tpu/data/rec_dataset.py), numpy only, without PIL.

The CTR projects' lmdbReader (stroke-level-decomposition/data/
lmdbReader.py:13-90): 'image-%09d' / 'label-%09d' keys, a resize to the
model's canvas, [-1, 1] normalisation. The JAX package decodes and
resizes with PIL; the port uses its own decoders and PIL's resamplers in
numpy (`data/image.py`), byte-equal to PIL's, so the arrays equal JAX's:

* `RecLMDBDataset`: decode to RGB, BICUBIC resize (`resize_bicubic`);
* `OrientationLMDBDataset`: decode, PIL's ROTATE_90 (counter-clockwise,
  `np.rot90`) where 1.5 * w < h, BILINEAR resize (`resize_bilinear`);
* `SyntheticCharDataset`: every random draw is JAX's, in its order, and
  so is every pixel outside the drawn character's neighbourhood; the
  character itself comes from the port's bitmap font (`data/glyphs.py`),
  where JAX draws PIL's FreeType default font (ROADMAP C17).
"""

from __future__ import annotations

import random
import string
from typing import Optional, Tuple

import numpy as np

from fudanocr_tpu_torch.data.glyphs import draw_text
from fudanocr_tpu_torch.data.image import (decode_image, resize_bicubic,
                                           resize_bilinear)
from fudanocr_tpu_torch.data.lmdb_store import LMDBReader
from fudanocr_tpu_torch.data.workers import rows_of


def str_q2b(s: str) -> str:
    """Full-width -> half-width normalisation (image-ids-CTR lmdbReader's
    strQ2B): ideographic space U+3000 -> space, FF01-FF5E -> ASCII."""
    out = []
    for ch in s:
        code = ord(ch)
        if code == 0x3000:
            code = 32
        elif 0xFF01 <= code <= 0xFF5E:
            code -= 0xFEE0
        out.append(chr(code))
    return "".join(out)


def random_sequential_order(n: int, batch_size: int, seed: int = 0):
    """randomSequentialSampler (dataset.py:205-228): each batch is a random
    CONTIGUOUS run of indices, sequential LMDB reads from random starts."""
    rng = random.Random(seed)
    order = []
    n_batch, tail = divmod(n, batch_size)
    for _ in range(n_batch):
        start = rng.randint(0, n - batch_size)
        order.extend(range(start, start + batch_size))
    if tail:
        start = rng.randint(0, n - batch_size)
        order.extend(range(start, start + tail))
    return order


def _normalize(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (lmdbReader.py resizeNormalize)."""
    return np.asarray(img, np.float32) / 127.5 - 1.0


class RecLMDBDataset:
    """Items (float32 (H, W, 3) image in [-1, 1], label) from one or more
    LMDB roots read one after another; `image_size` is (H, W)."""

    def __init__(self, roots, image_size: Tuple[int, int] = (32, 32),
                 alphabet: Optional[str] = None):
        if isinstance(roots, str):
            roots = [roots]
        self.readers = [LMDBReader(r) for r in roots]
        self.counts = [int(r.get(b"num-samples") or 0) for r in self.readers]
        self.image_size = image_size
        self.alphabet = set(alphabet) if alphabet else None

    def __len__(self):
        return sum(self.counts)

    def _locate(self, index):
        for reader, count in zip(self.readers, self.counts):
            if index < count:
                return reader, index + 1
            index -= count
        raise IndexError(index)

    def _read(self, index):
        reader, i = self._locate(index)
        label = (reader.get(b"label-%09d" % i) or b"").decode()
        return decode_image(reader.get(b"image-%09d" % i)), label

    def _size(self):
        return self.image_size[1], self.image_size[0]

    def __getitem__(self, index):
        img, label = self._read(index)
        return _normalize(resize_bicubic(img, self._size())), label

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0):
        """(images (B, H, W, 3), labels) per full batch; with an
        alphabet, labels with other characters are dropped and the batch
        refilled with its last sample, as in JAX."""
        order = list(range(len(self)))
        if shuffle:
            random.Random(seed).shuffle(order)
        for start in range(0, len(self) - batch_size + 1, batch_size):
            samples = [self[i] for i in order[start:start + batch_size]]
            if self.alphabet is not None:
                samples = [(a, l) for a, l in samples
                           if all(ch in self.alphabet for ch in l)]
                while len(samples) < batch_size and samples:
                    samples.append(samples[-1])
            if not samples:
                continue
            yield np.stack([a for a, _ in samples]), [l for _, l in samples]


class OrientationLMDBDataset(RecLMDBDataset):
    """OI-CTR reader (orientation-independent-CTR/data/lmdbReader.py:80-
    133): 1.5 * w >= h is horizontal (is_v 0), else vertical (is_v 1,
    rotated 90 degrees counter-clockwise into the horizontal frame).
    Batches yield (images, labels, is_v int32)."""

    def __getitem__(self, index):
        img, label = self._read(index)
        h, w = img.shape[:2]
        is_v = 0 if 1.5 * w >= h else 1
        if is_v:
            img = np.ascontiguousarray(np.rot90(img))
        return _normalize(resize_bilinear(img, self._size())), label, is_v

    def batches(self, batch_size: int, **_):
        for start in range(0, len(self) - batch_size + 1, batch_size):
            samples = [self[i] for i in range(start, start + batch_size)]
            yield (np.stack([a for a, _, _ in samples]),
                   [l for _, l, _ in samples],
                   np.asarray([v for _, _, v in samples], np.int32))


class SyntheticCharDataset:
    """Hermetic stand-in for the font-rendered char LMDBs: single
    'characters' (latin glyphs as proxies) on noisy canvases. Labels from
    `random.Random(seed)`; item i from `np.random.default_rng(seed * 7919
    + i)`: the text origin on a white (2H, 2W) canvas, a BICUBIC resize to
    (H, W), [-1, 1], then N(0, 0.02) noise."""

    def __init__(self, charset: Optional[str] = None, num_samples: int = 128,
                 image_size: Tuple[int, int] = (32, 32), seed: int = 0):
        self.charset = charset or (string.ascii_uppercase + string.digits)
        self.image_size = image_size
        rng = random.Random(seed)
        self.labels = [rng.choice(self.charset) for _ in range(num_samples)]
        self.seed = seed

    def __len__(self):
        return len(self.labels)

    def draws(self, index: int):
        """Item `index`'s draws: (text origin (x, y) on the 2x canvas, the
        rng left to draw the noise)."""
        rng = np.random.default_rng(self.seed * 7919 + index)
        h, w = self.image_size
        xy = (int(rng.integers(4, w)), int(rng.integers(2, h // 2)))
        return xy, rng

    def __getitem__(self, index):
        label = self.labels[index]
        xy, rng = self.draws(index)
        h, w = self.image_size
        img = np.full((h * 2, w * 2, 3), 255, np.uint8)
        draw_text(img, xy, label, 0)
        arr = _normalize(resize_bicubic(img, (w, h)))
        arr += rng.normal(0, 0.02, arr.shape).astype(np.float32)
        return arr, label

    builds_rows = True   # `batches(shard=)`: a data-parallel rank's rows

    def batches(self, batch_size: int, shard: Tuple[int, int] = (0, 1),
                **_):
        for start in range(0, len(self) - batch_size + 1, batch_size):
            samples = [self[i] for i in rows_of(
                range(start, start + batch_size), shard)]
            yield (np.stack([a for a, _ in samples]),
                   [l for _, l in samples])
