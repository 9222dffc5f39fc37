"""Dataset-creation tools (port of fudanocr_tpu/data/create_lmdb.py:21-76;
reference create_lmdb.py:184-534).

One generic writer over an iterator of (image, label) samples, the paired
SR writer, and the enumeration helpers of the common corpus layouts.
Images are uint8 numpy arrays, (H, W, 3) RGB or (H, W) gray, where the JAX
package takes PIL images; the helpers yield them decoded by
`data/image.decode_image`. Host code: numpy only, no device.

The recognition writer re-encodes every image with the port's JPEG
encoder (`data/jpeg.encode_jpeg`), which is not PIL's libjpeg: the keys,
labels, counts and key order are the JAX package's, the JPEG bytes are
not.

    python -m fudanocr_tpu_torch.data.corpus_recipes <recipe> args...

runs the per-corpus recipes (data/corpus_recipes.py), which pass the
files' bytes through.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from fudanocr_tpu_torch.data.image import decode_image
from fudanocr_tpu_torch.data.jpeg import encode_jpeg
from fudanocr_tpu_torch.data.lmdb_dataset import create_dataset
from fudanocr_tpu_torch.data.lmdb_store import LMDBWriter


def as_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB, or (H, W) gray replicated to RGB as PIL's
    `convert("RGB")` does."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"a uint8 (H, W, 3) or (H, W) image, not "
                         f"{img.dtype} {img.shape}")
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img


def create_recognition_dataset(out_path: str,
                               samples: Iterable[Tuple[np.ndarray, str]],
                               quality: int = 95,
                               check_valid: bool = True) -> int:
    """(image, label) pairs -> 'image-%09d' / 'label-%09d' LMDB, numbered
    from 1, images re-encoded as JPEG at `quality`; with `check_valid`
    images narrower or lower than 2 pixels are skipped. Returns the count
    (also written as 'num-samples')."""
    writer = LMDBWriter(out_path)
    n = 0
    for img, label in samples:
        h, w = np.shape(img)[:2]
        if check_valid and (w < 2 or h < 2):
            continue
        n += 1
        writer.put(b"image-%09d" % n, encode_jpeg(as_rgb(img), quality))
        writer.put(b"label-%09d" % n, label.encode("utf-8"))
    writer.put(b"num-samples", str(n).encode())
    writer.write()
    return n


def create_sr_dataset(out_path: str,
                      samples: Iterable[Tuple[np.ndarray,
                                              Optional[np.ndarray], str]],
                      quality: int = 95) -> int:
    """(hr, lr or None, label) triples of uint8 images -> paired
    TextZoom-layout LMDB (`data/lmdb_dataset.create_dataset`; a gray
    image stays gray, as JAX's PIL image keeps its mode)."""
    return create_dataset(out_path, samples, quality)


def _read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())


def iter_imagedir_with_labelfile(img_dir: str, label_file: str,
                                 sep: str = " ") -> Iterator:
    """Corpus layout: a label file of `filename<sep>label` lines (the
    90k/800k synth layout); lines whose file is missing are skipped."""
    with open(label_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fname, _, label = line.partition(sep)
            path = os.path.join(img_dir, fname)
            if os.path.exists(path):
                yield _read(path), label


def iter_gt_pairs(img_dir: str, gt_dir: str, img_suffix: str = ".jpg",
                  gt_suffix: str = ".txt") -> Iterator:
    """Corpus layout: one gt text file per image (ICDAR style), in sorted
    file-name order; images without a gt file are skipped."""
    for fname in sorted(os.listdir(img_dir)):
        if not fname.endswith(img_suffix):
            continue
        gt = os.path.join(gt_dir, fname[:-len(img_suffix)] + gt_suffix)
        if os.path.exists(gt):
            with open(gt, encoding="utf-8") as f:
                label = f.read().strip()
            yield _read(os.path.join(img_dir, fname)), label
