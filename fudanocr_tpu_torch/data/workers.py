"""Multi-process host data loading (port of fudanocr_tpu/data/workers.py).

A pool of forked worker processes, each holding its own dataset instance
(its own LMDB mmap), reads, decodes, resizes and collates batches while
the card computes, and hands them back IN ORDER.

  * the dataset is constructed inside each worker from `factory` (mmap
    and file handles never cross a process boundary);
  * workers run numpy only: the parent may hold a CUDA context and
    torch's thread pools, and a forked child that calls torch can hang;
    the workers fork when the stream is made (`iter()`), in the calling
    thread, after the parent's garbage collector has run and with every
    object the parent holds frozen (`gc.freeze`), so that no child's
    collector frees an object of the parent's: a CUDA event or tensor
    left in an uncollected reference cycle (a trainer and a step that
    refer to each other) aborted a child freeing it;
  * at most 2 x num_workers batches are in flight, and they come back in
    submission order; a worker that raises, or dies, raises in the
    consumer (a dead worker breaks the pool: BrokenProcessPool);
  * `num_workers=0` runs the same steps in-process;
  * `drop_last` (default True, as in JAX) drops the last partial batch;
    serving passes False so every image is served;
  * `shard=(k, n)` makes only rank k's rows of each batch of the n ranks
    of a data-parallel run (`rows_of`).

Usage:
    factory = functools.partial(LRServingLMDBDataset, "/data/textzoom",
                                batch_hw=(32, 128))
    for lr in WorkerBatches(factory, 256, num_workers=8, drop_last=False):
        ...
"""

from __future__ import annotations

import collections
import gc
import itertools
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Sequence, Tuple

_WORKER_DS = None     # each worker process's own dataset


def rows_of(indices: Sequence, shard: Tuple[int, int]) -> Sequence:
    """Rank k's rows of a batch's indices when `shard` is (k, n): the
    [k·b, (k+1)·b) of n·b (core/mesh.Mesh.rows); all of them at (0, 1)."""
    index, size = shard
    if size == 1:
        return indices
    if len(indices) % size:
        raise ValueError(f"a batch of {len(indices)} rows does not divide "
                         f"across {size} ranks")
    b = len(indices) // size
    return indices[index * b:(index + 1) * b]


def _init_worker(factory: Callable):
    global _WORKER_DS
    _WORKER_DS = factory()


def _make_batch(indices: Sequence[int]):
    return _WORKER_DS.collate(_WORKER_DS.fetch_items(indices))


class WorkerBatches:
    """Order-preserving multi-process batch stream over an LMDB dataset."""

    def __init__(self, factory: Callable, batch_size: int,
                 num_workers: int = 0, drop_last: bool = True,
                 shard: Tuple[int, int] = (0, 1)):
        self.factory = factory
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.shard = shard

    def _chunks(self, n: int):
        for start in range(0, n, self.batch_size):
            chunk = list(range(start, min(start + self.batch_size, n)))
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            yield rows_of(chunk, self.shard)

    def __iter__(self):
        """The batch stream. With workers, the pool forks them here, in the
        calling thread, before the first batch is asked for: a forked child
        keeps only the forking thread and frees what every other thread's
        frames held, and a CUDA tensor freed in a child aborts it (CUDA
        cannot initialise after a fork). So call iter() where no other
        thread is inside a step (the main thread between steps), not from
        a feed thread while the main thread computes."""
        ds = self.factory()
        chunks = self._chunks(len(ds))
        if self.num_workers <= 0:
            return (ds.collate(ds.fetch_items(c)) for c in chunks)
        pool = ProcessPoolExecutor(
            self.num_workers, mp_context=mp.get_context("fork"),
            initializer=_init_worker, initargs=(self.factory,))
        gc.collect()
        gc.freeze()          # the first submit forks every worker
        try:
            ahead = collections.deque(
                pool.submit(_make_batch, c)
                for c in itertools.islice(chunks, 2 * self.num_workers))
        finally:
            gc.unfreeze()
        return self._stream(pool, ahead, chunks)

    @staticmethod
    def _stream(pool, ahead, chunks):
        try:
            while ahead:
                done = ahead.popleft()
                for c in itertools.islice(chunks, 1):
                    ahead.append(pool.submit(_make_batch, c))
                yield done.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
