"""Static-size segmentation batches (port of the numpy-only `_stack_batch`
and `_batches_from` of fudanocr_tpu/data/seg_dataset.py:27-57).

A batch is a dict of stacked numpy arrays, "img" (B, H, W, 3) float32,
"gt_seg" (B, H, W) int32, "valid" (B,) float32 and, when every sample has
one, "gt_det" (B, H, W) int32. The batch size is static: the last partial
batch is padded by repeating its last sample and `valid` marks the
padding, so training shapes stay fixed and evaluation counts every sample
once. The directory and synthetic datasets of the JAX module need PIL,
which the machine with the card lacks; they wait for the port's PIL-free
data path.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List

import numpy as np

Sample = Dict[str, np.ndarray]


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
                 shuffle: bool, seed: int,
                 drop_last: bool) -> Iterator[Dict]:
    """Batches of samples getitem(0..n-1), in order or shuffled by
    `random.Random(seed)` (the JAX module's order for the same seed)."""
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
        yield stack_batch([getitem(i) for i in idxs], valid)
