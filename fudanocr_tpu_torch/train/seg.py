"""Segmentation training: poly schedule, optimizers, train step and the
iteration-based trainer (port of fudanocr_tpu/train/seg.py: `poly_schedule`
:35-45, `make_seg_optimizer` :76-87, `layer_id_for_param` and
`make_layer_decay_optimizer` :90-148, `make_seg_train_step` :151-238,
`SegTrainer` :296-469; reference mmseg/apis/train.py:71-194, the
textformer configs' optimizer and mmseg/core/optimizers/
layer_decay_optimizer_constructor.py).

The step runs the segmentor's training forward (`train=True, generator=g`:
batch statistics, drop-path, head dropout), CE (plus Lovász where the
config weights it) on the full-resolution logits and, for a det-guided
model with `gt_det` in the batch, det_loss_ratio x the det loss on the det
logits taken to float32 and bilinearly upsampled to the label size; then
backward and one `SegAdam` update (train/state.py). A model built with
`dtype=torch.bfloat16` trains unchanged: its activations are bf16, its
parameters, gradients and Adam state float32 (as optax keeps them), and
the losses take the logits to float32. Everything runs eagerly on the
model's device, one process, one device.

Checkpoints keep the JAX trainer's layout (`core/checkpoint.py`):
`ckpt_dir/iter_{it}/` every `ckpt_every` iterations (the newest `max_keep`
kept) and `ckpt_dir/best/` on the best mIoU, each a meta.json (step, best)
beside two payloads: the port's state.pt (the reference-layout
state_dict, the `SegAdam` state and the step) and JAX's state.msgpack
(params, batch_stats and, in iter_, the optax state of JAX's
`make_seg_optimizer`; JAX's `SegTrainer.resume` reads it). `resume` (or
`auto_resume`, from the latest iter_ checkpoint) restores all of it from
state.pt, or from state.msgpack where the directory has no state.pt (a
checkpoint the JAX package wrote); the per-iteration generator is keyed
by the iteration, so a run resumed at an epoch boundary replays the
uninterrupted run's batches and dropout.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.core.logging import MetricsLogger
from fudanocr_tpu_torch.eval.seg_metrics import (intersect_and_union,
                                                 total_metrics)
from fudanocr_tpu_torch.losses.seg_losses import (cross_entropy_loss,
                                                  lovasz_softmax_loss,
                                                  seg_accuracy)
from fudanocr_tpu_torch.models.seg.encoder_decoder import slide_inference
from fudanocr_tpu_torch.train.state import SegAdam
from fudanocr_tpu_torch.utils.weights import jax_variables

log = logging.getLogger("fudanocr_tpu_torch.seg")

Batch = Dict[str, torch.Tensor]


def poly_schedule(base_lr: float, total_iters: int, power: float = 1.0,
                  warmup_iters: int = 1500, warmup_ratio: float = 1e-6,
                  min_lr: float = 0.0) -> Callable[[int], float]:
    """count -> lr: linear warmup from base_lr * warmup_ratio over
    `warmup_iters`, then polynomial decay to `min_lr` at `total_iters`; in
    float32, rounded where the JAX schedule rounds (near the end of a run
    1 - step / total cancels: 6.26e-6 for 6.25e-6 at 159,999 of 160k)."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(min(step, total_iters))
        if step < warmup_iters:
            ramp = f32(1 - warmup_ratio) * (step / f32(warmup_iters))
            return float(f32(base_lr) * (f32(warmup_ratio) + ramp))
        decay = (f32(1) - step / f32(total_iters)) ** f32(power)
        return float(f32(base_lr - min_lr) * decay + f32(min_lr))

    return schedule


def make_seg_optimizer(model: torch.nn.Module, base_lr: float = 6e-5,
                       weight_decay: float = 0.01,
                       total_iters: int = 160_000,
                       head_lr_mult: float = 10.0) -> SegAdam:
    """Adam with coupled decay 0.01 on tensors of ndim > 1, the decode
    head's lr x10, and the poly schedule."""
    return SegAdam(model, poly_schedule(base_lr, total_iters), weight_decay,
                   head_lr_mult)


def layer_id_for_param(name: str, num_layers: Sequence[int]) -> int:
    """The depth of a CascadeMiT parameter for layer-wise lr decay, from
    its port name, the id the JAX `layer_id_for_param` gives its
    counterpart: the stem (`conv1`, `bn1`) 0, the ResNet pyramid
    `layer{k}` k, the transformer stage `layers.{i}` 3 + its first layer's
    index over all stages (+ j for its layer j; its patch embed and final
    norm take the first), everything else (the fusion convs, a det head,
    a segmentor's top-level `backbone.` / `decode_head.`) 3 + total + 1."""
    parts = name.split(".")
    top = parts[0]
    if top in ("conv1", "bn1"):
        return 0
    if top in ("layer1", "layer2", "layer3"):
        return int(top[5])
    if top == "layers":
        stage = int(parts[1])
        off = 3 + sum(num_layers[:stage])
        return off + int(parts[3]) if parts[2] == "1" else off
    return 3 + sum(num_layers) + 1


def make_layer_decay_optimizer(model: torch.nn.Module, base_lr: float = 6e-5,
                               weight_decay: float = 0.01,
                               total_iters: int = 160_000,
                               decay_rate: float = 0.9,
                               num_layers: Sequence[int] = (2, 2, 2, 2)
                               ) -> SegAdam:
    """Layer-wise lr decay: lr x decay_rate^(max_id - layer id) over the
    poly schedule, max_id = 3 + sum(num_layers) + 1
    (layer_decay_optimizer_constructor.py:162), Adam with coupled decay on
    tensors of ndim > 1, as the JAX optimizer."""
    max_id = 3 + sum(num_layers) + 1
    return SegAdam(model, poly_schedule(base_lr, total_iters), weight_decay,
                   lr_mult=lambda name: decay_rate ** (
                       max_id - layer_id_for_param(name, num_layers)))


def make_seg_train_step(model: torch.nn.Module, optimizer: SegAdam,
                        loss_weights: Optional[Dict[str, float]] = None,
                        det_loss_ratio: float = 0.1,
                        gt_guided_masks: bool = False,
                        lovasz_impl: str = "sort"
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """`step(batch, generator) -> metrics`: one update of `model`.

    `batch` holds "img" (B, H, W, 3) float, "gt_seg" (B, H, W) int and,
    optionally, "gt_det" and "valid" (B,) (padded samples' labels become
    255, ignored). `generator` (on the model's device) feeds drop-path and
    dropout. With `gt_guided_masks` the loaded det annotation replaces the
    predicted text map in the attention masks. The metrics are device
    tensors: "loss" and the terms "ce", "lovasz", "det" (those the recipe
    has) and "acc". Only the exact sort-based Lovász is ported."""
    if lovasz_impl != "sort":
        raise NotImplementedError(f"lovasz_impl={lovasz_impl!r}: the port "
                                  "has only the exact 'sort' Lovász")
    weights = loss_weights or {"ce": 1.0}

    def terms(logits, gt) -> Dict[str, torch.Tensor]:
        out = {}
        if weights.get("ce"):
            out["ce"] = cross_entropy_loss(logits, gt)
        if weights.get("lovasz"):
            out["lovasz"] = lovasz_softmax_loss(logits, gt)
        return out

    def step(batch: Batch, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        img, gt = batch["img"], batch["gt_seg"]
        gt_det, valid = batch.get("gt_det"), batch.get("valid")
        if valid is not None:   # padded tail samples contribute no loss
            keep = valid[:, None, None] > 0
            gt = torch.where(keep, gt, 255)
            if gt_det is not None:
                gt_det = torch.where(keep, gt_det, 255)
        kwargs = {}
        if gt_guided_masks and gt_det is not None:
            kwargs["det_gt"] = torch.where(gt_det == 255, 0, gt_det)
        optimizer.zero_grad()
        out = model(img, train=True, generator=generator, **kwargs)
        logits, det_logits = out if isinstance(out, tuple) else (out, None)
        loss = 0.0
        aux = {}
        if det_logits is not None and gt_det is not None:
            up = F.interpolate(det_logits.float().permute(0, 3, 1, 2),
                               size=tuple(gt_det.shape[1:]), mode="bilinear",
                               align_corners=False).permute(0, 2, 3, 1)
            det_loss = 0.0
            for name, t in terms(up, gt_det).items():
                det_loss = det_loss + weights[name] * t
            aux["det"] = det_loss
            loss = loss + det_loss_ratio * det_loss
        for name, t in terms(logits, gt).items():
            aux[name] = t
            loss = loss + weights[name] * t
        aux["acc"] = seg_accuracy(logits.detach(), gt)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    return step


def iteration_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of iteration `it`: seeded from (seed, it) alone, so a
    run resumed at `it` draws what the uninterrupted run drew (the JAX
    trainer's `fold_in(PRNGKey(seed), it)`)."""
    state = np.random.SeedSequence([seed, it]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


class SegTrainer:
    """Iteration loop with periodic evaluation (mIoU / mDice / mFscore).

    `train_data` and `eval_data` are objects with `.batches(batch_size,
    shuffle=False, seed=0)` yielding dicts of numpy arrays (see
    data/seg_dataset.py). `model` comes initialised and on its device,
    where the batches are moved. `crop` evaluates with the sliding window
    (`stride` defaults to `crop`), else the whole image. With `log_dir`, a
    `MetricsLogger` records the train metrics every 50 iterations, each
    evaluation and a prediction table of its first batch."""

    def __init__(self, model: torch.nn.Module, train_data, eval_data,
                 num_classes: int = 2, batch_size: int = 4,
                 lr: float = 6e-5, total_iters: int = 1000,
                 eval_every: int = 1000,
                 loss_weights: Optional[Dict[str, float]] = None,
                 crop: Optional[Tuple[int, int]] = None,
                 stride: Optional[Tuple[int, int]] = None,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 det_loss_ratio: float = 0.1,
                 gt_guided_masks: bool = False, lovasz_impl: str = "sort",
                 log_dir: Optional[str] = None,
                 ckpt_every: Optional[int] = None,
                 auto_resume: bool = False, max_keep: int = 3):
        self.model = model
        self.train_data = train_data
        self.eval_data = eval_data
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.total_iters = total_iters
        self.eval_every = eval_every
        self.crop = crop
        self.stride = stride
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every or eval_every
        self.max_keep = max_keep
        self.seed = seed
        self.device = next(model.parameters()).device
        self.optimizer = make_seg_optimizer(model, lr,
                                            total_iters=total_iters)
        self.train_step = make_seg_train_step(
            model, self.optimizer, loss_weights, det_loss_ratio,
            gt_guided_masks, lovasz_impl)
        self.start_iter = 0
        self.best = -1.0
        self.metrics_logger = MetricsLogger(log_dir) if log_dir else None
        if auto_resume and ckpt_dir:
            path = ckpt_lib.latest(ckpt_dir, prefix="iter_")
            if path:
                self.resume(path)

    def _payload(self) -> dict:
        return {"state_dict": self.model.state_dict(),
                "optimizer": self.optimizer.adam.state_dict(),
                "step": self.optimizer.count}

    def _jax_tree(self, opt_state: bool) -> dict:
        """The JAX trainer's checkpoint tree: params, batch_stats and, with
        `opt_state`, the optimizer's state."""
        tree = jax_variables(self.model)
        if opt_state:
            tree["opt_state"] = self.optimizer.jax_opt_state(self.model)
        return tree

    def resume(self, ckpt_path: str) -> None:
        """Restore the weights, BN statistics, optimizer state, iteration
        and best mIoU from a checkpoint directory (the runner's
        resume_from / --auto-resume): its state.pt, or its state.msgpack
        where it has no state.pt."""
        meta = ckpt_lib.load_meta(ckpt_path)
        if ckpt_lib.has_payload(ckpt_path):
            payload = ckpt_lib.load(ckpt_path, map_location=self.device)
            self.model.load_state_dict(payload["state_dict"])
            self.optimizer.adam.load_state_dict(payload["optimizer"])
            self.optimizer.count = self.start_iter = int(payload["step"])
        else:
            tree = ckpt_lib.load_jax(ckpt_path)
            if "opt_state" not in tree:
                raise ValueError(f"{ckpt_path}: no optimizer state (a best/ "
                                 "checkpoint?); resume from an iter_ one")
            self.model.load_state_dict(ckpt_lib.jax_state_dict(tree,
                                                               self.model))
            self.optimizer.load_jax_opt_state(
                self.model, tree["opt_state"], tree["batch_stats"])
            self.start_iter = int(meta.get("step", 0))
        self.best = float(meta.get("best", -1.0))
        log.info("resumed from %s at iter %d", ckpt_path, self.start_iter)

    def _save_periodic(self, it: int) -> None:
        ckpt_lib.save(os.path.join(self.ckpt_dir, f"iter_{it}"),
                      self._payload(), meta={"step": it, "best": self.best},
                      jax_tree=self._jax_tree(opt_state=True))
        subs = sorted((d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("iter_")), key=lambda d: int(d[5:]))
        for d in subs[:-self.max_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)

    def _device_batch(self, batch) -> Batch:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def train(self, stop_after: Optional[int] = None) -> int:
        """Run from `start_iter` to total_iters (or stop after
        `stop_after` iterations, the schedule staying the full recipe's);
        returns the iteration reached."""
        it = self.start_iter
        stop = min(self.total_iters,
                   self.total_iters if stop_after is None else stop_after)
        while it < stop:
            for batch in self.train_data.batches(self.batch_size,
                                                 shuffle=True, seed=it):
                if it >= stop:
                    break
                metrics = self.train_step(
                    self._device_batch(batch),
                    iteration_generator(self.seed, it, self.device))
                it += 1
                if it % 50 == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    log.info("iter %d/%d %s", it, self.total_iters, m)
                    if self.metrics_logger:
                        self.metrics_logger.scalars(m, it, "train/")
                if it % self.eval_every == 0:
                    self.evaluate(it)
                if self.ckpt_dir and it % self.ckpt_every == 0:
                    self._save_periodic(it)
        return it

    def evaluate(self, it: int = 0,
                 save_best: bool = True) -> Dict[str, float]:
        """mIoU / mDice / mFscore over `eval_data`. With a `ckpt_dir` and
        `save_best`, a result at or above the best so far (>=, as JAX's)
        writes `ckpt_dir/best/`."""
        model = self.model

        def fwd(x):
            out = model(x)
            return out[0] if isinstance(out, tuple) else out

        hist = np.zeros((4, self.num_classes), np.float64)
        with torch.inference_mode():
            for bi, batch in enumerate(self.eval_data.batches(
                    self.batch_size)):
                b = self._device_batch(batch)
                img = b["img"].float()
                logits = (slide_inference(fwd, img, self.crop,
                                          self.stride or self.crop)
                          if self.crop is not None else fwd(img))
                pred = logits.argmax(-1)
                gt = b["gt_seg"]
                if "valid" in b:   # padded tail samples count nothing
                    gt = torch.where(b["valid"][:, None, None] > 0, gt, 255)
                if bi == 0 and self.metrics_logger is not None:
                    self.metrics_logger.prediction_table(
                        it, batch["img"], batch["gt_seg"],
                        pred.cpu().numpy())
                counts = intersect_and_union(pred, gt, self.num_classes)
                hist += torch.stack(counts).cpu().numpy()
        res = total_metrics(*hist)
        summary = {k: res[k] for k in ("aAcc", "mIoU", "mDice", "mFscore")}
        log.info("eval @%d: %s", it, summary)
        if self.metrics_logger:
            self.metrics_logger.scalars(summary, it, "eval/")
        if self.ckpt_dir and save_best and res["mIoU"] >= self.best:
            self.best = res["mIoU"]
            ckpt_lib.save(os.path.join(self.ckpt_dir, "best"),
                          self._payload(),
                          meta={"step": self.optimizer.count,
                                "best": self.best, **summary},
                          jax_tree=self._jax_tree(opt_state=False))
        return summary
