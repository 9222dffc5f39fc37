"""LMDB-backed SR datasets (TextZoom layout), without PIL (port of
fudanocr_tpu/data/lmdb_dataset.py: `LMDBDataset`, `PairedLMDBDataset`,
`LRServingLMDBDataset`, `MixLMDBDataset`, `create_dataset`).

Keys follow the reference layout: 'image_hr-%09d', 'image_lr-%09d' (or
'image-%09d' for an HR-only store) and 'label-%09d' with 1-based indices,
and 'num-samples'. Every batch reads its keys in one pass per store.
Images decode with data/image.py (JPEG or PNG, byte-equal to PIL's
decode) into uint8 (H, W, 3) arrays; batches are fixed-shape NHWC numpy
arrays. Nothing here calls
torch, so the datasets run inside forked worker processes.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fudanocr_tpu_torch.data.collate import resize_normalize, sr_collate
from fudanocr_tpu_torch.data.image import decode_image, resize_bicubic
from fudanocr_tpu_torch.data.jpeg import encode_jpeg
from fudanocr_tpu_torch.data.lmdb_store import LMDBReader, LMDBWriter
from fudanocr_tpu_torch.data.workers import rows_of
from fudanocr_tpu_torch.eval.metrics import str_filt


class _LMDBBase:
    def __init__(self, roots, voc_type: str = "upper", batch_hw=(32, 128),
                 scale: int = 2):
        if isinstance(roots, str):
            roots = [roots]
        self.readers = [LMDBReader(r) for r in roots]
        self.counts = [int(r.get(b"num-samples") or 0) for r in self.readers]
        self.voc_type = voc_type
        self.batch_hw = batch_hw
        self.scale = scale

    def __len__(self):
        return sum(self.counts)

    def _locate(self, index: int):
        for reader, count in zip(self.readers, self.counts):
            if index < count:
                return reader, index + 1  # keys are 1-based
            index -= count
        raise IndexError(index)

    def _label(self, raw: Optional[bytes]) -> str:
        return str_filt((raw or b"").decode(), self.voc_type)

    def _lookup(self, indices: Sequence[int], kinds: Sequence[bytes]):
        """The values of `kinds` (key prefixes) for each index, one
        `get_many` per reader -> [[value per kind] per index]."""
        located = [self._locate(i) for i in indices]
        by_reader: dict = {}
        for pos, (reader, i) in enumerate(located):
            by_reader.setdefault(id(reader), (reader, []))[1].append((pos, i))
        out: List = [None] * len(indices)
        n = len(kinds)
        for reader, entries in by_reader.values():
            got = reader.get_many([k + b"-%09d" % i for _, i in entries
                                   for k in kinds])
            for j, (pos, _) in enumerate(entries):
                out[pos] = got[n * j:n * j + n]
        return out

    def collate(self, items, **collate_kw):
        kw = dict(img_h=self.batch_hw[0], img_w=self.batch_hw[1],
                  down_sample_scale=self.scale)
        kw.update(collate_kw)
        return sr_collate(items, **kw)

    # `batches(shard=)` reads only a data-parallel rank's rows
    builds_rows = True

    def batches(self, batch_size: int, drop_last: bool = True,
                shard: Tuple[int, int] = (0, 1), **collate_kw) -> Iterator:
        """Collated batches in index order; the last partial batch too
        when `drop_last` is False. `shard=(k, n)` reads and collates only
        rank k's rows of each (`data/workers.rows_of`)."""
        stop = len(self) - batch_size + 1 if drop_last else len(self)
        for start in range(0, max(stop, 0), batch_size):
            end = min(start + batch_size, len(self))
            yield self.collate(self.fetch_items(
                rows_of(range(start, end), shard)), **collate_kw)


class LMDBDataset(_LMDBBase):
    """HR-only LMDB (lmdbDataset + alignCollate_syn): the LR image is the
    HR's bicubic downsample by `scale` (PIL's BICUBIC, `resize_bicubic`).
    The HR comes from 'image_hr-', else from 'image-'."""

    def __getitem__(self, index: int):
        return self.fetch_items([index])[0]

    def fetch_items(self, indices: Sequence[int]) -> List:
        out = []
        for hr, plain, label in self._lookup(
                indices, (b"image_hr", b"image", b"label")):
            img = decode_image(hr if hr is not None else plain)
            lr = resize_bicubic(img, (img.shape[1] // self.scale,
                                      img.shape[0] // self.scale))
            out.append((img, lr, self._label(label)))
        return out


class PairedLMDBDataset(_LMDBBase):
    """Real paired HR/LR LMDB (lmdbDataset_real): items (hr, lr, label)."""

    def __getitem__(self, index: int):
        return self.fetch_items([index])[0]

    def fetch_items(self, indices: Sequence[int]) -> List:
        kinds = (b"image_hr", b"image_lr", b"label")
        return [(decode_image(hr), decode_image(lr), self._label(label))
                for hr, lr, label in self._lookup(indices, kinds)]


class LRServingLMDBDataset(_LMDBBase):
    """LR-only view of a paired LMDB for serving: items are the decoded
    LR images. It reads neither the HR image nor the 'label-' key.
    `collate` makes ONE (B, h, w, 3) batch, uint8 by default
    (normalisation runs on the device, `normalize_uint8`)."""

    def fetch_items(self, indices: Sequence[int]) -> List:
        return [decode_image(lr)
                for lr, in self._lookup(indices, (b"image_lr",))]

    def collate(self, items, dtype=None):
        dtype = np.uint8 if dtype is None else dtype
        h, w = self.batch_hw
        lr_size = (w // self.scale, h // self.scale)
        return np.stack([resize_normalize(img, lr_size, dtype=dtype)
                         for img in items])


class MixLMDBDataset(_LMDBBase):
    """lmdbDataset_mix (dataset.py:155-202): in training the LR image is
    the stored LR with probability 0.5, else the HR itself, the coin drawn
    from `random.Random(seed)` only for items that have a stored LR, in
    index order (the JAX class's draws); with `test` the stored LR when
    there is one. An item without 'image_hr-' reads 'image-' as HR and
    has no LR."""

    # the coins come from one generator in read order: forked workers
    # would each draw from a copy of it (train/sr.SRTrainer refuses that),
    # and a rank reading only its rows would draw others
    draws_in_read_order = True
    builds_rows = False

    def __init__(self, *args, test: bool = False, seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.test = test
        self._rng = random.Random(seed)

    def __getitem__(self, index: int):
        return self.fetch_items([index])[0]

    def fetch_items(self, indices: Sequence[int]) -> List:
        out = []
        for hr, lr, plain, label in self._lookup(
                indices, (b"image_hr", b"image_lr", b"image", b"label")):
            if hr is None:
                hr, lr = plain, None
            hr_img = decode_image(hr)
            if lr and (self.test or self._rng.random() < 0.5):
                lr_img = decode_image(lr)
            else:
                lr_img = hr_img
            out.append((hr_img, lr_img, self._label(label)))
        return out


def create_dataset(out_path: str, samples, quality: int = 95) -> int:
    """createDataset (create_lmdb.py:184-233): write (hr, lr or None,
    label) triples of uint8 (H, W, 3) images into a new LMDB as JPEG at
    `quality` (data/jpeg.encode_jpeg). Returns the sample count."""
    writer = LMDBWriter(out_path)
    n = 0
    for hr, lr, label in samples:
        n += 1
        writer.put(b"image_hr-%09d" % n, encode_jpeg(hr, quality))
        if lr is not None:
            writer.put(b"image_lr-%09d" % n, encode_jpeg(lr, quality))
        writer.put(b"label-%09d" % n, label.encode())
    writer.put(b"num-samples", str(n).encode())
    writer.write()
    return n
