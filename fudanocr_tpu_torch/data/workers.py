"""Multi-process host data loading (port of fudanocr_tpu/data/workers.py).

A pool of forked worker processes, each holding its own dataset instance
(its own LMDB mmap), reads, decodes, resizes and collates batches while
the card computes, and hands them back IN ORDER.

  * the dataset is constructed inside each worker from `factory` (mmap
    and file handles never cross a process boundary);
  * workers run numpy only: the parent may hold a CUDA context and
    torch's thread pools, and a forked child that calls torch can hang;
  * at most 2 x num_workers batches are in flight, and they come back in
    submission order; a worker that raises, or dies, raises in the
    consumer (a dead worker breaks the pool: BrokenProcessPool);
  * `num_workers=0` runs the same steps in-process;
  * `drop_last` (default True, as in JAX) drops the last partial batch;
    serving passes False so every image is served.

Usage:
    factory = functools.partial(LRServingLMDBDataset, "/data/textzoom",
                                batch_hw=(32, 128))
    for lr in WorkerBatches(factory, 256, num_workers=8, drop_last=False):
        ...
"""

from __future__ import annotations

import collections
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Sequence

_WORKER_DS = None     # each worker process's own dataset


def _init_worker(factory: Callable):
    global _WORKER_DS
    _WORKER_DS = factory()


def _make_batch(indices: Sequence[int]):
    return _WORKER_DS.collate(_WORKER_DS.fetch_items(indices))


class WorkerBatches:
    """Order-preserving multi-process batch stream over an LMDB dataset."""

    def __init__(self, factory: Callable, batch_size: int,
                 num_workers: int = 0, drop_last: bool = True):
        self.factory = factory
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last

    def _chunks(self, n: int):
        for start in range(0, n, self.batch_size):
            chunk = list(range(start, min(start + self.batch_size, n)))
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            yield chunk

    def __iter__(self):
        ds = self.factory()
        if self.num_workers <= 0:
            for chunk in self._chunks(len(ds)):
                yield ds.collate(ds.fetch_items(chunk))
            return
        pool = ProcessPoolExecutor(
            self.num_workers, mp_context=mp.get_context("fork"),
            initializer=_init_worker, initargs=(self.factory,))
        try:
            ahead = collections.deque()
            for chunk in self._chunks(len(ds)):
                ahead.append(pool.submit(_make_batch, chunk))
                if len(ahead) >= 2 * self.num_workers:
                    yield ahead.popleft().result()
            while ahead:
                yield ahead.popleft().result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
