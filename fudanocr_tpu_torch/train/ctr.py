"""CTR (Chinese text/character recognition) trainer (port of
fudanocr_tpu/train/ctr.py: `masked_token_ce` :33-40, the train step
:43-67, `CTRTrainer` :70-166).

One trainer for the reference forks (SLD, image-ids-CTR; SURVEY.md
section 2.9): teacher-forced CE training of the shared OCRTransformer with
Adadelta (sld/train.py:35-39), periodic greedy-decode evaluation, host
rectification (the Levenshtein snap of stroke mode) and best-checkpoint
tracking (sld/train.py:80-176). The reference's ragged `text_all`
packing (util.py:108-116) is a masked dense CE: both average the
per-token CE over real tokens only.

Training runs on the model's one device (the JAX trainer's batch mesh is
ROADMAP A8). `best/` is a `core/checkpoint` directory with the port's
payload (the reference-layout state_dict, the optimizer state and the
step) and the JAX trainer's (state.msgpack: params and batch_stats).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.models.rec.ocr_transformer import greedy_decode
from fudanocr_tpu_torch.train.seg import iteration_generator
from fudanocr_tpu_torch.train.state import ScheduledOptimizer, ctr_adadelta
from fudanocr_tpu_torch.utils.weights import jax_variables

log = logging.getLogger("fudanocr_tpu_torch.ctr")

Batch = Dict[str, torch.Tensor]


def length_mask(lengths: torch.Tensor, l: int) -> torch.Tensor:
    """(B,) lengths -> (B, L) float32, 1 at the real positions."""
    pos = torch.arange(l, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()


def masked_token_ce(logits: torch.Tensor, targets: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Mean fp32 CE over the valid positions of (B, L, C) logits against
    (B, L) ids."""
    mask = length_mask(lengths, targets.shape[1])
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def token_ce_loss(out: Dict[str, torch.Tensor], batch: Batch) -> torch.Tensor:
    return masked_token_ce(out["pred"], batch["text_gt"], batch["lengths"])


def make_ctr_train_step(model: torch.nn.Module,
                        optimizer: ScheduledOptimizer,
                        loss_fn: Optional[Callable] = None):
    """`step(batch, generator) -> loss` (a device tensor): the training
    forward of `model` on batch["image"] (B, H, W, 3) and
    batch["text_input"], `loss_fn(out, batch)` (the masked token CE by
    default), backward and one update. `generator` feeds dropout."""
    loss_fn = loss_fn or token_ce_loss

    def step(batch: Batch, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        optimizer.zero_grad()
        out = model(batch["image"], batch["text_input"], train=True,
                    generator=generator)
        loss = loss_fn(out, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def ids_to_strings(ids: np.ndarray, alphabet, terminator: Optional[str],
                   rectifier=None) -> List[str]:
    """Decoded id rows -> strings, each cut at its first terminator and
    snapped by `rectifier` when given (JAX `decode_batch`)."""
    out = []
    for row in ids:
        toks = []
        for t in row:
            tok = alphabet[int(t)]
            if tok == terminator:
                break
            toks.append(tok)
        s = "".join(toks)
        out.append(rectifier(s) if rectifier is not None else s)
    return out


class CTRTrainer:
    """Teacher-forced training and greedy-decode evaluation of a model on
    its device. `train_data` / `eval_data` have `.batches(batch_size)`
    yielding (images (B, H, W, 3) float32, labels). `decode_ids(images)`
    replaces the greedy decode (CCR-CLIP stage 2 matches a gallery);
    `loss_fn(out, batch)` replaces the masked token CE."""

    def __init__(self, model: torch.nn.Module, codec, train_data, eval_data,
                 batch_size: int = 32, lr: float = 1.0,
                 weight_decay: float = 0.0, epochs: int = 1,
                 eval_every: int = 1000, max_len: int = 30,
                 rectifier=None, ckpt_dir: Optional[str] = None,
                 seed: int = 0, loss_fn: Optional[Callable] = None,
                 decode_ids: Optional[Callable] = None):
        self.model = model
        self.codec = codec
        self.train_data = train_data
        self.eval_data = eval_data
        self.batch_size = batch_size
        self.epochs = epochs
        self.eval_every = eval_every
        self.max_len = max_len
        self.rectifier = rectifier
        self.ckpt_dir = ckpt_dir
        self.seed = seed
        self.device = next(model.parameters()).device
        self.optimizer = ctr_adadelta(model.parameters(), lr, weight_decay)
        self.train_step = make_ctr_train_step(model, self.optimizer, loss_fn)
        self.decode_ids = decode_ids or (
            lambda images: greedy_decode(model, images, max_len))
        self.step = 0
        self.best_acc = -1.0
        self.history = []

    def device_batch(self, images, labels) -> Batch:
        text_input, text_gt, lengths = self.codec.encode(labels, self.max_len)
        put = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)
        return {"image": put(images), "text_input": put(text_input).long(),
                "text_gt": put(text_gt).long(), "lengths": put(lengths)}

    def train(self):
        for epoch in range(self.epochs):
            for images, labels in self.train_data.batches(self.batch_size):
                loss = self.train_step(
                    self.device_batch(images, labels),
                    iteration_generator(self.seed, self.step, self.device))
                self.step += 1
                if self.step % 50 == 0:
                    log.info("epoch %d iter %d loss %.4f", epoch, self.step,
                             float(loss))
                if self.step % self.eval_every == 0:
                    self.evaluate(self.step)
        return self.step

    def decode_batch(self, images) -> List[str]:
        """Greedy-decoded strings of a host batch: the ids are copied to
        the host once."""
        x = torch.from_numpy(np.asarray(images)).to(self.device)
        ids = self.decode_ids(x).cpu().numpy()
        return ids_to_strings(ids, self.codec.alphabet, self.codec.terminator,
                              self.rectifier)

    def save_best(self, meta: Dict) -> None:
        ckpt_lib.save(os.path.join(self.ckpt_dir, "best"),
                      {"state_dict": self.model.state_dict(),
                       "optimizer": self.optimizer.state_dict(),
                       "step": self.step}, meta=meta,
                      jax_tree=jax_variables(self.model))

    def evaluate(self, it: int = 0) -> Dict[str, float]:
        total, correct = 0, 0
        for images, labels in self.eval_data.batches(self.batch_size):
            preds = self.decode_batch(images)
            for p, gt_label in zip(preds, labels):
                gt = "".join(self.codec.decompose(gt_label))
                term = self.codec.terminator
                if term and gt.endswith(term):
                    gt = gt[:-len(term)]
                correct += int(p == gt)
                total += 1
        acc = correct / max(total, 1)
        self.history.append({"iter": it, "acc": acc})
        log.info("eval @%d: acc %.4f (%d/%d)", it, acc, correct, total)
        if self.ckpt_dir and acc >= self.best_acc:
            self.best_acc = acc
            self.save_best({"step": self.step, "acc": acc})
        return {"acc": acc}
