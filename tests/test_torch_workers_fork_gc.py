"""The forked feed workers (fudanocr_tpu_torch/data/workers.py) free no
object of the parent's. A reference cycle that the parent's collector has
not yet reached when the workers fork stands in for the CUDA event or
tensor of an uncollected trainer-and-step cycle, whose destructor aborts a
forked child: its finaliser must run in the parent alone, also when each
worker runs its collector (the dataset factory collects in the workers)."""

import gc
import multiprocessing as mp
import os

import numpy as np

from fudanocr_tpu_torch.data.workers import WorkerBatches


class _Finalised:
    """A cycle whose finaliser appends the pid it runs in to `path`."""

    def __init__(self, path):
        self.path, self.me = path, self

    def __del__(self):
        with open(self.path, "a") as f:
            f.write(f"{os.getpid()}\n")


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def fetch_items(self, indices):
        return list(indices)

    def collate(self, items):
        return np.asarray(items)


def _factory():
    if mp.parent_process() is not None:       # in a worker
        gc.collect()
    return _Rows(8)


def test_workers_free_nothing_of_the_parents(tmp_path):
    path = tmp_path / "finalised"
    gc.disable()
    try:
        _Finalised(str(path))       # garbage the collector has not seen
        batches = list(WorkerBatches(_factory, 2, num_workers=2))
    finally:
        gc.enable()
    assert [b.tolist() for b in batches] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert path.read_text().split() == [str(os.getpid())]
