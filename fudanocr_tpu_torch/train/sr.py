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
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fudanocr_tpu_torch.data.codecs import SequenceCodec, english_stroke_codec
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter, ctc_greedy_decode
from fudanocr_tpu_torch.eval.metrics import psnr, sequence_accuracy, ssim
from fudanocr_tpu_torch.losses.sr_losses import encode_text_labels
from fudanocr_tpu_torch.models.rec.crnn import parse_crnn_input
from fudanocr_tpu_torch.train.state import AdamWithClip, adam_with_clip

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
    of strings. `eval_data` may be a dict of difficulty buckets
    (easy/medium/hard); the best checkpoint then tracks the summed accuracy
    (super_resolution.py:103-135). `model` comes initialised (e.g. from a
    seed) and on its device; `seed` seeds the dropout generator.

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
                 seed: int = 1234):
        self.model = model
        self.loss_fn = loss_fn
        self.train_data = train_data
        self.eval_data = eval_data
        self.batch_size = batch_size
        self.epochs = epochs
        self.eval_every = eval_every
        self.max_label_len = max_label_len
        self.ckpt_dir = ckpt_dir
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

    def resume(self, ckpt_path: str) -> None:
        """Restore the model's weights and BatchNorm statistics from a
        checkpoint written by `evaluate` (the reference's --resume)."""
        ckpt = torch.load(ckpt_path, map_location=self.device)
        self.model.load_state_dict(ckpt["state_dict_G"])
        self.step = int(ckpt.get("step", 0))
        log.info("resumed from %s", ckpt_path)

    def _encode(self, labels):
        """Labels -> (text_input, text_gt, lengths) for the loss."""
        return encode_text_labels(labels, self.max_label_len)

    def _device_batch(self, hr, lr, labels) -> Batch:
        text_input, text_gt, lengths = self._encode(labels)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(
                self.device, non_blocking=True)

        return {"hr": dev(hr, torch.float32), "lr": dev(lr, torch.float32),
                "text_input": dev(text_input, torch.int64),
                "text_gt": dev(text_gt, torch.int64),
                "lengths": dev(lengths, torch.int64)}

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
            for bi, (hr, lr, labels) in enumerate(
                    self.train_data.batches(self.batch_size)):
                batch = self._device_batch(hr, lr, labels)
                if self._use_hr_cache:
                    batch["hr_map"] = self._hr_map(bi, batch)
                metrics = self.train_step(batch, self.generator)
                self.step += 1
                if self.step % 50 == 0:
                    log.info("epoch %d iter %d %s", epoch, self.step,
                             {k: float(v) for k, v in metrics.items()})
                if self.step % self.eval_every == 0:
                    self.evaluate(self.step)

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
        "metrics"}."""
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
        if self.ckpt_dir and res.get("acc", res.get("psnr", 0.0)) >= \
                self.best.get("acc", -1.0):
            self.best = res
            os.makedirs(self.ckpt_dir, exist_ok=True)
            torch.save({"state_dict_G": self.model.state_dict(),
                        "step": self.step, "metrics": res},
                       os.path.join(self.ckpt_dir, "best.pt"))
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
