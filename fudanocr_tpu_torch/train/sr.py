"""SR training: train step, eval step and the trainer loop (port of
fudanocr_tpu/train/sr.py; reference scene-text-telescope/interfaces/
super_resolution.py:37-239).

The train step scales the loss x100 before the backward, so the 0.25
global-norm clip bites where the reference's does, then clips and runs
Adam (`train.state.adam_with_clip`); the BatchNorm running statistics
move in the forward. The eval step super-resolves through the inference
path (TBSRN's fused-enhancer kernel, TSRN's fused GRU kernel when its
`fused_gru` is on), scores PSNR/SSIM, and reads the SR image with a CRNN
when one is given. `StrokeSRTrainer` is Text Gestalt's trainer: the same
loop with the stroke codec's labels. Everything runs eagerly on the
model's device, one process, one device.

The training feed reads, decodes and collates in `num_workers` forked
processes (`data/workers.WorkerBatches`, the reference's DataLoader
workers), and a thread encodes the labels and stages each batch one
ahead (`data/prefetch.PrefetchIterator`: pinned memory, a side-stream
copy), as the serving path does. With no workers all of it runs in the
main thread before each step. JAX's feed runs the host work on a thread
of its own; here that thread holds the GIL against the step's launches
and ran slower than the main thread (chip_smoke.py phase 27a on an H100).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.core.logging import MetricsLogger
from fudanocr_tpu_torch.data.codecs import SequenceCodec, english_stroke_codec
from fudanocr_tpu_torch.data.image import resize_bicubic
from fudanocr_tpu_torch.data.png import encode_png
from fudanocr_tpu_torch.data.prefetch import PrefetchIterator
from fudanocr_tpu_torch.data.workers import WorkerBatches
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter, ctc_greedy_decode
from fudanocr_tpu_torch.eval.metrics import psnr, sequence_accuracy, ssim
from fudanocr_tpu_torch.losses.sr_losses import encode_text_labels
from fudanocr_tpu_torch.models.rec.crnn import parse_crnn_input
from fudanocr_tpu_torch.train.state import AdamWithClip, adam_with_clip
from fudanocr_tpu_torch.utils.weights import jax_variables

log = logging.getLogger("fudanocr_tpu_torch.sr")

Batch = Dict[str, torch.Tensor]


def make_sr_train_step(model: torch.nn.Module, loss_fn,
                       optimizer: AdamWithClip, loss_scale: float = 100.0
                       ) -> Callable[..., Dict[str, torch.Tensor]]:
    """`step(batch, generator) -> metrics`: one update of `model`.

    `batch` holds "lr", "hr" (NHWC), "text_input", "text_gt", "lengths"
    and, optionally, a precomputed frozen-oracle "hr_map"; `generator`
    (on the model's device) feeds dropout. `loss_fn(sr, hr, text_input,
    text_gt, lengths[, hr_map]) -> (loss, aux)`. The metrics are device
    tensors: "loss" (x loss_scale, as the JAX step reports it), the aux
    terms and "grad_norm" (before the clip)."""

    def step(batch: Batch, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        sr = model(batch["lr"], train=True, generator=generator)
        extra = {"hr_map": batch["hr_map"]} if "hr_map" in batch else {}
        loss, aux = loss_fn(sr, batch["hr"], batch["text_input"],
                            batch["text_gt"], batch["lengths"], **extra)
        scaled = loss * loss_scale
        scaled.backward()
        norm = optimizer.step()
        return {"loss": scaled.detach(), "grad_norm": norm,
                **{k: v.detach() for k, v in aux.items()}}

    return step


def make_sr_eval_step(model: torch.nn.Module,
                      recognizer: Optional[torch.nn.Module] = None
                      ) -> Callable[[torch.Tensor, torch.Tensor], Batch]:
    """`step(lr, hr) -> {"sr", "psnr", "ssim"[, "rec_ids"]}` under
    inference mode. The SR output (tanh, in [-1, 1]) is scored against the
    [0, 1] HR as it is, as the reference does; the recognizer reads it
    bicubic-resized to 32x100 gray (`parse_crnn_input`) and gives greedy
    CTC ids."""

    def step(lr: torch.Tensor, hr: torch.Tensor) -> Batch:
        with torch.inference_mode():
            sr = model(lr)
            sr01 = sr.float()
            out = {"sr": sr, "psnr": psnr(sr01[..., :3], hr[..., :3]),
                   "ssim": ssim(sr01[..., :3], hr[..., :3])}
            if recognizer is not None:
                out["rec_ids"] = ctc_greedy_decode(
                    recognizer(parse_crnn_input(sr)))
        return out

    return step


class SRTrainer:
    """Epoch loop with periodic evaluation and best-checkpoint tracking.

    `train_data` and `eval_data` are objects with `.batches(batch_size)`
    yielding (hr, lr, labels): NHWC float numpy arrays in [0, 1] and a list
    of strings. With `num_workers`, `train_data` also has
    `fetch_items(indices)` and `collate(items)` (the LMDB and synthetic
    sets), and the workers fork with it. `eval_data` may be a dict of
    difficulty buckets (easy/medium/hard); the best checkpoint then tracks
    the summed accuracy (super_resolution.py:103-135). `model` comes
    initialised (e.g. from a seed) and on its device; `seed` seeds the
    dropout generator.

    With a text-focus loss the frozen oracle's HR attention map of each
    batch ordinal is computed once, in epoch 0, and reused from then on
    (iteration order is deterministic), kept on the device up to
    `hr_cache_cap_bytes` (4 GiB)."""

    def __init__(self, model: torch.nn.Module, loss_fn, train_data,
                 eval_data, batch_size: int = 64, lr: float = 1e-4,
                 epochs: int = 2, eval_every: int = 1000,
                 max_label_len: int = 32, ckpt_dir: Optional[str] = None,
                 recognizer: Optional[torch.nn.Module] = None,
                 converter: Optional[CTCLabelConverter] = None,
                 seed: int = 1234, log_dir: Optional[str] = None,
                 num_workers: int = 0):
        self.model = model
        self.loss_fn = loss_fn
        self.train_data = train_data
        self.eval_data = eval_data
        self.batch_size = batch_size
        self.epochs = epochs
        self.eval_every = eval_every
        self.max_label_len = max_label_len
        self.ckpt_dir = ckpt_dir
        self.num_workers = num_workers
        self.converter = converter
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.optimizer = adam_with_clip(model.parameters(), lr)
        self.train_step = make_sr_train_step(model, loss_fn, self.optimizer)
        self.eval_step = make_sr_eval_step(model, recognizer)
        self.step = 0
        self._use_hr_cache = (getattr(loss_fn, "text_focus", False)
                              and getattr(loss_fn, "oracle", None)
                              is not None)
        self._hr_map_cache: Dict[int, torch.Tensor] = {}
        self._hr_cache_bytes = 0
        self.hr_cache_cap_bytes = 4 << 30
        self.history = []
        self.best = {"acc": -1.0, "psnr": -1.0}
        self.metrics_logger = MetricsLogger(log_dir) if log_dir else None

    def resume(self, ckpt_path: str) -> None:
        """Restore the model's weights and BatchNorm statistics from a
        checkpoint written by `evaluate` (the reference's --resume): a
        `best.pt`, or a checkpoint directory in the JAX package's format
        (`best/`, also what the JAX trainer writes), read through the
        model's porter."""
        if os.path.isdir(ckpt_path):
            self.model.load_state_dict(ckpt_lib.load_model_state(
                ckpt_path, module=self.model))
            self.step = int(ckpt_lib.load_meta(ckpt_path).get("step", 0))
        else:
            ckpt = torch.load(ckpt_path, map_location=self.device)
            self.model.load_state_dict(ckpt["state_dict_G"])
            self.step = int(ckpt.get("step", 0))
        log.info("resumed from %s", ckpt_path)

    def _encode(self, labels):
        """Labels -> (text_input, text_gt, lengths) for the loss."""
        return encode_text_labels(labels, self.max_label_len)

    def _host_batch(self, hr, lr, labels) -> Dict[str, np.ndarray]:
        """A collated batch with its labels encoded, as host arrays."""
        text_input, text_gt, lengths = self._encode(labels)
        return {"hr": np.asarray(hr, np.float32),
                "lr": np.asarray(lr, np.float32),
                "text_input": np.asarray(text_input, np.int64),
                "text_gt": np.asarray(text_gt, np.int64),
                "lengths": np.asarray(lengths, np.int64)}

    def host_batches(self, data) -> Iterator[Dict[str, np.ndarray]]:
        """`data`'s training batches as `_host_batch` makes them: read,
        decoded and collated by `num_workers` forked processes, or in the
        calling thread with none."""
        if not self.num_workers:
            batches = data.batches(self.batch_size)
        elif getattr(data, "draws_in_read_order", False):
            raise ValueError(f"{type(data).__name__} draws from one "
                             "generator in read order; forked workers "
                             "would each draw from a copy of it: train it "
                             "with num_workers=0")
        else:
            # the workers fork with `data` (an LMDB store is a read-only
            # mmap) and keep the batches in order
            batches = WorkerBatches(lambda: data, self.batch_size,
                                    num_workers=self.num_workers)
        for hr, lr, labels in batches:
            yield self._host_batch(hr, lr, labels)

    def feed(self, data) -> Iterator[Batch]:
        """`data`'s training batches on the device: with `num_workers`,
        `host_batches` on a thread that stages each batch one ahead; with
        none, in the main thread before each step."""
        if self.num_workers:
            return PrefetchIterator(self.host_batches(data), self.device,
                                    buffer_size=1)
        return (self._to_device(b) for b in self.host_batches(data))

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _device_batch(self, hr, lr, labels) -> Batch:
        return self._to_device(self._host_batch(hr, lr, labels))

    def _hr_map(self, ordinal: int, batch: Batch) -> torch.Tensor:
        """The frozen oracle's HR attention map of the batch at this epoch
        ordinal, from the cache when it holds one."""
        cached = self._hr_map_cache.get(ordinal)
        if cached is not None:
            return cached
        m = self.loss_fn.hr_oracle_map(batch["hr"], batch["text_input"])
        nbytes = m.numel() * m.element_size()
        if self._hr_cache_bytes + nbytes <= self.hr_cache_cap_bytes:
            self._hr_map_cache[ordinal] = m
            self._hr_cache_bytes += nbytes
        return m

    def train(self) -> None:
        for epoch in range(self.epochs):
            batches = self.feed(self.train_data)
            try:
                for bi, batch in enumerate(batches):
                    if self._use_hr_cache:
                        batch["hr_map"] = self._hr_map(bi, batch)
                    metrics = self.train_step(batch, self.generator)
                    self.step += 1
                    if self.step % 50 == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        log.info("epoch %d iter %d %s", epoch, self.step, m)
                        if self.metrics_logger:
                            self.metrics_logger.scalars(m, self.step,
                                                        "train/")
                    if self.step % self.eval_every == 0:
                        self.evaluate(self.step)
            finally:
                batches.close()

    def demo(self, out_dir: str, n_vis: int = 10) -> str:
        """Write `n_vis` LR|SR|HR strips of `eval_data` (the LR bicubic-
        upsampled to the HR size, the SR clipped to [0, 1]) as PNG files
        "{i:03d}_{label}.png" to `out_dir` (the reference's --demo image
        dumps, super_resolution.py:331-425)."""
        os.makedirs(out_dir, exist_ok=True)
        data = self.eval_data
        if isinstance(data, dict):       # the first difficulty bucket
            data = next(iter(data.values()))
        written = 0
        for hr, lr, labels in data.batches(self.batch_size):
            batch = self._device_batch(hr, lr, labels)
            out = self.eval_step(batch["lr"], batch["hr"])
            sr = out["sr"].float().clamp(0, 1).cpu().numpy()
            h, w = hr.shape[1], hr.shape[2]
            for i in range(sr.shape[0]):
                if written >= n_vis:
                    return out_dir
                lr_up = resize_bicubic(
                    (lr[i, ..., :3] * 255).astype(np.uint8),
                    (w, h)).astype(np.float32) / 255.0
                strip = np.concatenate(
                    [lr_up, sr[i, ..., :3], hr[i, ..., :3]], axis=1)
                with open(os.path.join(out_dir,
                                       f"{written:03d}_{labels[i]}.png"),
                          "wb") as f:
                    f.write(encode_png((strip * 255).astype(np.uint8)))
                written += 1
        return out_dir

    def _evaluate_one(self, data) -> Dict[str, float]:
        psnrs, ssims, preds, gts = [], [], [], []
        for hr, lr, labels in data.batches(self.batch_size):
            batch = self._device_batch(hr, lr, labels)
            out = self.eval_step(batch["lr"], batch["hr"])
            psnrs.append(float(out["psnr"]))
            ssims.append(float(out["ssim"]))
            if "rec_ids" in out and self.converter is not None:
                preds.extend(self.converter.decode_ids(
                    out["rec_ids"].cpu().numpy()))
                gts.extend(labels)
        res = {"psnr": float(np.mean(psnrs)) if psnrs else 0.0,
               "ssim": float(np.mean(ssims)) if ssims else 0.0}
        if gts:
            res["acc"] = sequence_accuracy(preds, gts)
        return res

    def evaluate(self, it: int = 0) -> Dict[str, float]:
        """PSNR/SSIM (and accuracy with a recognizer and converter) over
        `eval_data`; saves the best checkpoint to `ckpt_dir/best.pt` as
        {"state_dict_G": the reference-layout state_dict, "step",
        "metrics"}, and to `ckpt_dir/best/` as the JAX trainer does
        (state.msgpack with params and batch_stats, meta.json with the
        step and metrics)."""
        if isinstance(self.eval_data, dict):
            res: Dict[str, float] = {}
            acc_sum = 0.0
            for name, data in self.eval_data.items():
                bucket = self._evaluate_one(data)
                log.info("eval[%s] @%d: %s", name, it, bucket)
                for k, v in bucket.items():
                    res[f"{name}_{k}"] = v
                acc_sum += bucket.get("acc", bucket["psnr"])
            res["acc"] = acc_sum
        else:
            res = self._evaluate_one(self.eval_data)
        self.history.append({"iter": it, **res})
        log.info("eval @%d: %s", it, res)
        if self.metrics_logger:
            self.metrics_logger.scalars(res, it, "eval/")
        if self.ckpt_dir and res.get("acc", res.get("psnr", 0.0)) >= \
                self.best.get("acc", -1.0):
            self.best = res
            os.makedirs(self.ckpt_dir, exist_ok=True)
            torch.save({"state_dict_G": self.model.state_dict(),
                        "step": self.step, "metrics": res},
                       os.path.join(self.ckpt_dir, "best.pt"))
            ckpt_lib.save_jax(os.path.join(self.ckpt_dir, "best"),
                              jax_variables(self.model),
                              meta={"step": self.step, **res})
        return res


class StrokeSRTrainer(SRTrainer):
    """Text Gestalt's trainer (fudanocr_tpu/apps/text_gestalt/main.py:
    71-78): `SRTrainer` whose labels go through the stroke codec (ten
    stroke classes, terminator '0'; `data/codecs.english_stroke_codec`,
    its built-in fallback table when `codec` is None), for a
    `losses/stroke_focus.StrokeFocusLoss` over the frozen stroke oracle
    `OCRTransformer(vocab=10, num_in=1, layers=(1, 2, 5, 3),
    num_heads=16)`."""

    def __init__(self, *args, codec: Optional[SequenceCodec] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.codec = codec or english_stroke_codec(None)

    def _encode(self, labels):
        return self.codec.encode(labels, self.max_label_len)
