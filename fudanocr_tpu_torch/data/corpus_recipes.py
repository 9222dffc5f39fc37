"""Per-corpus LMDB creation recipes (port of fudanocr_tpu/data/
corpus_recipes.py:26-193; reference scene-text-telescope/dataset/
create_lmdb.py:236-534 and crop_800k.py).

Each recipe enumerates one corpus layout in the JAX package's order,
applies its size filters and writes the same key schema
('image-%09d' / 'label-%09d' / 'num-samples'; the detection layout adds
'boxes_x-' / 'boxes_y-' / 'region_mask-' / 'pixel_mask-',
create_lmdb.py:69-127). The files' bytes go into the database unchanged,
and `LMDBWriter` is the JAX package's writer line for line, so each
database is byte for byte the JAX package's from the same files. Where a
recipe asks whether a file is an image, and its size, it reads the header
alone (`data/image.image_size`, the answer of PIL's lazy `Image.open`): a
file PIL cannot open is skipped, one PIL opens and the port cannot read
(GIF, BMP, ...) raises. `crop_words` cuts word boxes out of a numpy image.
Host code: numpy only, no device.

    python -m fudanocr_tpu_torch.data.corpus_recipes <recipe> args...

with <recipe> one of `RECIPES`: 800k <odgt> <out>, 90k <root> <out>,
ic <odgt> <out_dir>, gt_txt <root> <out>.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from fudanocr_tpu_torch.data.image import image_size
from fudanocr_tpu_torch.data.lmdb_store import LMDBWriter


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_samples(out_path: str, samples: Iterable[Tuple[bytes, dict]],
                   log_every: int = 1000) -> int:
    """samples: (image bytes, {key suffix: bytes}) -> the reference key
    schema, numbered from 1; prints progress every `log_every`."""
    writer = LMDBWriter(out_path)
    n = 0
    for image_bin, extra in samples:
        n += 1
        writer.put(b"image-%09d" % n, image_bin)
        for suffix, data in extra.items():
            writer.put(b"%s-%09d" % (suffix.encode(), n), data)
        if n % log_every == 0:
            print(f"collected {n}")
    writer.put(b"num-samples", str(n).encode())
    writer.write()
    print(f"created dataset with {n} samples at {out_path}")
    return n


def create_800k(odgt_path: str, out_path: str, min_h: int = 64,
                min_w: int = 256) -> int:
    """SynthText crops from an .odgt json-lines manifest
    (create_lmdb.py:236-270: keep h >= 64 and w >= 256)."""
    def gen():
        with open(odgt_path) as f:
            for line in f:
                rec = json.loads(line)
                path = os.path.join(rec["im_path"], rec["im_name"])
                size = image_size(path)
                if size is None:
                    continue
                w, h = size
                if h >= min_h and w >= min_w:
                    yield _bytes(path), {"label": rec["label"].encode()}
    return _write_samples(out_path, gen())


def create_90k(root: str, out_path: str, min_w: int = 100,
               min_h: int = 31) -> int:
    """MJSynth 90kDICT32px tree, two directory levels in sorted order; the
    label is the `*_LABEL_*` field of the file name (create_lmdb.py:
    370-406: keep w >= 100 and h >= 31)."""
    def gen():
        for d1 in sorted(os.listdir(root)):
            p1 = os.path.join(root, d1)
            if "." in d1 or not os.path.isdir(p1):
                continue
            for d2 in sorted(os.listdir(p1)):
                p2 = os.path.join(p1, d2)
                if not os.path.isdir(p2):
                    continue
                for fname in sorted(os.listdir(p2)):
                    path = os.path.join(p2, fname)
                    size = image_size(path)
                    if size is None:
                        continue
                    w, h = size
                    if w >= min_w and h >= min_h:
                        label = fname.split("_")[1]
                        yield _bytes(path), {"label": label.encode()}
    return _write_samples(out_path, gen())


def create_ic(odgt_path: str, out_dir: str, image_root: str = "") -> dict:
    """ICDAR13/15 train/test LMDBs from one .odgt manifest whose `dataset`
    and `type` fields route each line to `out_dir/<dataset>_<type>`
    (create_lmdb.py:408-460); returns {name: count}."""
    buckets: dict = {}
    with open(odgt_path) as f:
        for line in f:
            rec = json.loads(line)
            name = rec["img_path"]
            if image_root:
                name = os.path.join(image_root, os.path.basename(name))
            if not os.path.exists(name) or image_size(name) is None:
                continue
            key = f"{rec['dataset'].lower()}_{rec['type']}"
            buckets.setdefault(key, []).append((name, rec["img_gt"]))
    return {key: _write_samples(os.path.join(out_dir, key),
                                ((_bytes(p), {"label": label.encode()})
                                 for p, label in items))
            for key, items in buckets.items()}


def create_gt_txt(root: str, out_path: str, gt_file: str = "gt.txt") -> int:
    """SVT-Perspective-style corpora: a `name label` gt file in `root`
    (create_lmdb.py:462-477)."""
    def gen():
        with open(os.path.join(root, gt_file)) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                name, label = parts[0], parts[1].strip()
                path = os.path.join(root, name)
                if os.path.exists(path) and image_size(path) is not None:
                    yield _bytes(path), {"label": label.encode()}
    return _write_samples(out_path, gen())


def create_detection(out_path: str, image_paths: Sequence[str],
                     boxes_x: Sequence[str], boxes_y: Sequence[str],
                     labels: Optional[Sequence[str]] = None,
                     region_masks: Optional[Sequence[str]] = None,
                     pixel_masks: Optional[Sequence[str]] = None) -> int:
    """Detection-layout LMDB (TotalText / IIIT5K variants,
    create_lmdb.py:69-127): per sample its polygon coordinate strings and,
    where given, its label and region / pixel mask files; samples with
    empty boxes or a missing image are skipped."""
    def gen():
        for i, path in enumerate(image_paths):
            if not boxes_x[i] or not os.path.exists(path):
                continue
            extra = {"boxes_x": boxes_x[i].encode(),
                     "boxes_y": boxes_y[i].encode()}
            if labels:
                extra["label"] = labels[i].encode()
            if region_masks:
                extra["region_mask"] = _bytes(region_masks[i])
            if pixel_masks:
                extra["pixel_mask"] = _bytes(pixel_masks[i])
            yield _bytes(path), extra
    return _write_samples(out_path, gen())


def crop_words(img: np.ndarray, polygons: Sequence[Sequence[Tuple[
        float, float]]]) -> List[np.ndarray]:
    """Axis-aligned word crops of an (H, W[, C]) image from polygon
    annotations, the geometry of crop_800k.py:37-60: each polygon's
    bounding box, floor / ceil, clamped to the image; empty boxes are
    dropped."""
    h, w = img.shape[:2]
    crops = []
    for poly in polygons:
        xs = [p[0] for p in poly]
        ys = [p[1] for p in poly]
        x0, x1 = max(math.floor(min(xs)), 0), min(math.ceil(max(xs)), w)
        y0, y1 = max(math.floor(min(ys)), 0), min(math.ceil(max(ys)), h)
        if x1 > x0 and y1 > y0:
            crops.append(img[y0:y1, x0:x1])
    return crops


RECIPES = {
    "800k": (create_800k, ("odgt_path", "out_path")),
    "90k": (create_90k, ("root", "out_path")),
    "ic": (create_ic, ("odgt_path", "out_dir")),
    "gt_txt": (create_gt_txt, ("root", "out_path")),
}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="per-corpus LMDB recipes")
    p.add_argument("recipe", choices=sorted(RECIPES))
    p.add_argument("args", nargs="+")
    ns = p.parse_args(argv)
    fn, _ = RECIPES[ns.recipe]
    print(fn(*ns.args))


if __name__ == "__main__":
    main()
