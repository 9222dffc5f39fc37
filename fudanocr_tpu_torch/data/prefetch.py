"""Asynchronous host -> device staging (port of fudanocr_tpu/data/prefetch.py).

A background thread pulls host batches (a numpy array, or a dict of them)
and stages each on the device while the consumer's stream runs the
previous step: on CUDA it pins each array (`pin_memory()`), copies it with
`non_blocking=True` on a side stream of its own and records an event. The
consumer's `next()` makes its current stream wait on that event and calls
`record_stream` on each tensor, so the caching allocator does not hand a
buffer out again before the consumer's work on it is done. On the CPU the
staged batch is the array as a tensor (a dict of them). Whatever the
source iterator computes (decoding, collating, label encoding) runs on the
thread. An exception in the thread is raised in the consumer.
`close()` (or the end of the stream) stops the thread and closes the
source iterator.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

Device = Union[str, torch.device]
_END = object()


def _apply(fn, batch):
    """fn over an array, or over each value of a dict of arrays."""
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


class PrefetchIterator:
    """Stage `buffer_size` batches of `batches` ahead on `device`."""

    def __init__(self, batches: Iterator, device: Device = "cuda",
                 buffer_size: int = 2):
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._err: Optional[Exception] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._work, args=(batches,),
                                        daemon=True)
        self._thread.start()

    def _copy(self, arr) -> torch.Tensor:
        if self._stream is None:
            return torch.as_tensor(arr, device=self.device)
        pinned = torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
        return pinned.to(self.device, non_blocking=True)

    def _stage(self, batch):
        if self._stream is None:
            return _apply(self._copy, batch), None
        with torch.cuda.stream(self._stream):
            batch = _apply(self._copy, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return batch, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, batches):
        try:
            for batch in batches:
                if not self._put(self._stage(batch)):
                    break
        except Exception as e:  # raised in the consumer
            self._err = e
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
            self._put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _END:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            _apply(lambda t: t.record_stream(stream), batch)
        return batch

    def close(self) -> None:
        """Stop the thread (after the batch it is staging) and close the
        source iterator."""
        self._stop.set()
        self._thread.join()

