"""Batched inference serving (port of fudanocr_tpu/serving.py).

`PixelsToStrings` composes LR pixels -> SR -> bicubic 32x100 -> gray ->
CRNN -> greedy CTC argmax on the device; only the [B, T] ids cross to the
host, which joins the strings. `LMDBToStrings` serves a whole LMDB through
it: LR-only decode and resize on host workers, uint8 batches staged on the
card, normalisation there, strings out. `InferenceServer` coalesces concurrent
single-image requests into fixed-bucket batches, pads the tail, and
scatters results to per-request futures, with the JAX server's bucket,
padding, deadline and close semantics.

Usage:
    sr = TBSRN(dtype=torch.bfloat16).to(dev).eval()
    crnn = CRNN(37, 256, dtype=torch.bfloat16).to(dev).eval()
    pipe = PixelsToStrings(sr, crnn, CTCLabelConverter(alphabet), device=dev)
    texts = pipe(lr_batch)              # list[str], len B
    for texts in LMDBToStrings(pipe, "/data/textzoom_test", batch_size=256):
        ...                             # list[str] per batch, in order
    srv = InferenceServer(pipe.ids_fn, buckets=(1, 8, 32), device=dev)
    ids = srv.submit(lr_image).result() # (T,) ids; pipe.decode_ids(ids[None])
    srv.close()

Design notes (as in the JAX server):
  * buckets are sorted ascending; a flush runs either a FULL largest bucket
    (under load) or, once the first waiter's max_wait_ms budget expires,
    the smallest bucket that fits every pending same-shape request, padded;
  * requests of different image shapes are served in same-shape runs;
  * the batcher thread is the only thread that touches the device, so
    device work is issued in request order from one stream;
  * padding replicates the first request's image; padded outputs are
    dropped before scatter.
Each bucket runs eagerly; capturing one CUDA graph per bucket is later
work (ROADMAP.md).
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fudanocr_tpu_torch.data.collate import normalize_uint8
from fudanocr_tpu_torch.data.lmdb_dataset import LRServingLMDBDataset
from fudanocr_tpu_torch.data.prefetch import PrefetchIterator
from fudanocr_tpu_torch.data.workers import WorkerBatches
from fudanocr_tpu_torch.eval.ctc import ctc_greedy_decode
from fudanocr_tpu_torch.models.rec.crnn import parse_crnn_input

Device = Union[str, torch.device]


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PixelsToStrings:
    """The composed OCR path, device-resident from LR pixels to CTC ids.

    `sr_apply` maps (B, h, w, 3) LR in [0, 1] to (B, H, W, 3) SR (e.g. a
    TBSRN module); `rec_apply` maps (B, 32, 100, 1) gray to (B, T, C)
    logits (e.g. a CRNN). Everything runs eagerly under
    `torch.inference_mode()` on `device`.
    """

    def __init__(self, sr_apply: Callable, rec_apply: Callable, converter,
                 rec_hw: Tuple[int, int] = (32, 100),
                 device: Device = "cuda"):
        self.sr_apply, self.rec_apply = sr_apply, rec_apply
        self.converter = converter
        self.rec_hw = tuple(rec_hw)
        self.device = torch.device(device)

    def ids_and_sr(self, lr) -> Tuple[torch.Tensor, torch.Tensor]:
        """LR batch -> ([B, T] ids, SR) on the device. A tensor already on
        the device is used as it is; an array is copied there first."""
        with torch.inference_mode():
            lr = torch.as_tensor(lr, device=self.device)
            sr = self.sr_apply(lr)
            # the reference bicubics SR output to 32x100 and converts to
            # 1-channel gray before its CRNN(32,1,37,256)
            # (interfaces/base.py:310,319-325 parse_crnn_data)
            logits = self.rec_apply(parse_crnn_input(sr, self.rec_hw))
            return ctc_greedy_decode(logits), sr

    def ids_fn(self, lr) -> torch.Tensor:
        """LR batch -> [B, T] ids on the device (for InferenceServer)."""
        return self.ids_and_sr(lr)[0]

    def __call__(self, lr_batch, return_sr: bool = False):
        ids, sr = self.ids_and_sr(lr_batch)
        texts = self.decode_ids(ids)
        return (texts, sr) if return_sr else texts

    def decode_ids(self, ids) -> List[str]:
        """Host join for [B, T] ids (a tensor or an array from a server)."""
        return self.converter.decode_ids(_to_numpy(ids))


class LMDBToStrings:
    """The serving journey over one LMDB: LR-only decode and resize on
    host workers (uint8) -> pinned copy to the device on a side stream ->
    `normalize_uint8` -> `pixels_to_strings.ids_fn` -> host string join.

    Every image is served, the last partial batch included, and no label
    is read. Batch i's work and the copy of its ids to the host are
    queued on the device before batch i-1's strings are joined, so the
    join and the next decodes overlap the device's work. Errors are not absorbed: a decode
    error, an unknown image format or a worker failure raises.

    Usage:
        for texts in LMDBToStrings(pipe, "/data/textzoom_test",
                                   batch_size=256, num_workers=8):
            ...                     # list[str] per batch, in order
    """

    BUFFER = 3    # batches staged on the device ahead of the consumer

    def __init__(self, pixels_to_strings: PixelsToStrings, db_path: str,
                 batch_size: int = 512,
                 batch_hw: Tuple[int, int] = (32, 128), scale: int = 2,
                 num_workers: int = 0, device: Optional[Device] = None):
        self._p2s = pixels_to_strings
        self.device = torch.device(pixels_to_strings.device if device is None
                                   else device)
        self._loader = WorkerBatches(
            functools.partial(LRServingLMDBDataset, db_path,
                              batch_hw=batch_hw, scale=scale),
            batch_size, num_workers=num_workers, drop_last=False)

    def _dispatch(self, lr: torch.Tensor):
        """Queue batch lr's ids and their copy to the host -> (host ids,
        event that marks the copy done, or None on the CPU)."""
        with torch.inference_mode():
            ids = self._p2s.ids_fn(normalize_uint8(lr))
            if self.device.type != "cuda":
                return ids, None
            host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            host.copy_(ids, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    def _join(self, pending) -> List[str]:
        host, done = pending
        if done is not None:
            done.synchronize()
        return self._p2s.decode_ids(host)

    def __iter__(self):
        stream = PrefetchIterator(iter(self._loader), device=self.device,
                                  buffer_size=self.BUFFER)
        pending = None
        try:
            for lr in stream:
                queued = self._dispatch(lr)
                if pending is not None:
                    yield self._join(pending)
                pending = queued
            if pending is not None:
                yield self._join(pending)
        finally:
            stream.close()


class InferenceServer:
    def __init__(self, apply_fn: Callable, buckets: Sequence[int] = (1, 8, 32),
                 max_wait_ms: float = 5.0, device: Device = "cuda"):
        if list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"buckets must be ascending unique: {buckets}")
        self._apply = apply_fn
        self.device = torch.device(device)
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[Tuple[np.ndarray, Future]]" = queue.Queue()
        # other work for the batcher thread (warmup), run between batches
        self._jobs: "queue.Queue[Tuple[Callable, Future]]" = queue.Queue()
        self._closed = threading.Event()
        self._submit_lock = threading.Lock()  # serializes submit vs close
        # bounded stats history: a long-lived server must not grow host RAM
        # with its request count (10k samples keep percentiles meaningful)
        self.batch_sizes = collections.deque(maxlen=10_000)  # buckets run
        self.latencies_ms = collections.deque(maxlen=10_000)  # submit->result
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image) -> Future:
        """Enqueue one (H, W, C) image; resolves to its output as numpy."""
        # the closed-check and the put must be atomic w.r.t. close():
        # otherwise a submit that passes the check can enqueue after the
        # post-join drain finished, stranding its Future forever
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("server is closed")
            fut: Future = Future()
            fut._enqueued_at = time.perf_counter()  # for stats()
            self._q.put((np.asarray(image), fut))
        return fut

    def _run(self, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return _to_numpy(self._apply(torch.from_numpy(x).to(self.device)))

    def warmup(self, example_image) -> None:
        """Run every bucket shape once, so serve-time requests pay no
        first-call cost (kernel build, cuDNN algorithm search).

        The batches run on the batcher thread, which stays the only thread
        that touches the device; this call blocks until they are done."""
        x1 = np.asarray(example_image)[None]
        fut: Future = Future()
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("server is closed")
            self._jobs.put((lambda: [self._run(np.repeat(x1, b, axis=0))
                                     for b in self.buckets], fut))
        fut.result()

    def stats(self) -> dict:
        """Request latencies (ms, submit -> result) and batch-size usage
        over the last <=10k requests (bounded history)."""
        lat = sorted(self.latencies_ms)
        if not lat:
            return {"requests": 0, "batches": list(self.batch_sizes)}
        pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
        return {"requests": len(lat), "p50_ms": round(pick(0.50), 3),
                "p99_ms": round(pick(0.99), 3),
                "max_ms": round(lat[-1], 3),
                "batches": list(self.batch_sizes)}

    def close(self):
        with self._submit_lock:
            self._closed.set()
        self._thread.join()
        # a submit() racing close() can enqueue after the batcher exits;
        # fail those futures instead of leaving clients blocked forever
        for q in (self._q, self._jobs):
            while True:
                try:
                    _, fut = q.get_nowait()
                except queue.Empty:
                    break
                fut.set_exception(
                    RuntimeError("server closed before serving"))

    # -- batcher ----------------------------------------------------------
    def _loop(self):
        pending: list = []
        deadline = None  # max_wait clock starts at the FIRST pending item
        while not (self._closed.is_set() and self._q.empty() and not pending):
            while not self._jobs.empty():
                job, fut = self._jobs.get_nowait()
                try:
                    fut.set_result(job())
                except Exception as e:  # the caller's result() raises it
                    fut.set_exception(e)
            if pending:
                timeout = max(deadline - time.perf_counter(), 1e-4)
            else:
                timeout = 0.05
            try:
                item = self._q.get(timeout=timeout)
                if not pending:
                    deadline = time.perf_counter() + self.max_wait
                pending.append(item)
                while len(pending) < self.buckets[-1]:
                    pending.append(self._q.get_nowait())
            except queue.Empty:
                pass
            if not pending:
                continue
            # flush when a full largest-bucket is ready, the first waiter's
            # latency budget is spent, or we're draining on close
            if (len(pending) >= self.buckets[-1]
                    or time.perf_counter() >= deadline
                    or self._closed.is_set()):
                self._flush(pending)
                deadline = time.perf_counter() + self.max_wait

    def _flush(self, pending: list):
        # batch only the leading run of SAME-SHAPE requests: a mismatched
        # image must not poison its batchmates (and np.stack must never
        # raise outside the error-routing below)
        shape = pending[0][0].shape
        n = 1
        while n < len(pending) and pending[n][0].shape == shape:
            n += 1
        if n >= self.buckets[-1]:
            bucket = self.buckets[-1]           # a full largest bucket
        else:
            bucket = next(b for b in self.buckets if b >= n)  # pad up:
            # _flush only runs at deadline/full/close, so the whole run
            # must leave NOW — taking a smaller bucket would strand the
            # remainder for another max_wait each
        take = min(n, bucket)
        batch, futs = zip(*pending[:take])
        del pending[:take]
        self.batch_sizes.append(bucket)
        try:
            x = np.stack(batch)
            if take < bucket:  # pad the tail to the static bucket shape
                pad = np.repeat(x[:1], bucket - take, axis=0)
                x = np.concatenate([x, pad], axis=0)
            out = self._run(x)
            done = time.perf_counter()
            for i, fut in enumerate(futs):
                self.latencies_ms.append(
                    (done - getattr(fut, "_enqueued_at", done)) * 1e3)
                fut.set_result(out[i])
        except Exception as e:  # surface runtime errors per-request
            for fut in futs:
                fut.set_exception(e)
