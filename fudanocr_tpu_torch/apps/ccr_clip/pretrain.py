"""CCR-CLIP stage 1: contrastive image-IDS pretraining (port of
fudanocr_tpu/apps/ccr_clip/pretrain.py).

image-ids-CTR/CCR-CLIP/main.py: batches of (char image, char) from
font-rendered datasets; the radical-token text tower; the symmetric CE
with first-occurrence targets; zero-shot retrieval evaluation against the
whole charset's text features (encoded in chunks of 100); Adam 1e-4
(0.9, 0.98, eps 1e-6) with lr x0.8 every 2 epochs after epoch 10.

    python -m fudanocr_tpu_torch.apps.ccr_clip.pretrain \\
        [--options k=v ...] [--device cuda]

Without alphabet/decompose files the JAX package's synthetic radical
system and `SyntheticCharDataset` stand in. One device; the contrastive
batch is the device's (ROADMAP C5). `best/` holds the port's payload
(`core/checkpoint`), which stage 2's `radical_model` reads.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict

import torch

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.core.config import Config, merge_cli_overrides
from fudanocr_tpu_torch.data.codecs import radical_codec
from fudanocr_tpu_torch.losses.clip_loss import (clip_symmetric_ce,
                                                 first_occurrence_targets)
from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP
from fudanocr_tpu_torch.train.state import ScheduledOptimizer, clip_adam

log = logging.getLogger("fudanocr_tpu_torch.ccr_clip")

DEFAULT_CONFIG = Config({
    "epoch": 1,
    "train_dataset": "",
    "test_dataset": "",
    "batch": 32,
    "imageW": 128,
    "imageH": 128,
    "alphabet_path": "",
    "decompose_path": "",
    "max_len": 30,
    "lr": 1e-4,
    "ckpt_dir": "./ckpt/ccr_clip",
    "val_frequency": 1000,
    "synthetic_samples": 64,
    "test_only": False,
    "transformer_layers": 12,
})


def make_clip_train_step(model: CCRCLIP, optimizer: ScheduledOptimizer):
    """`step(images, text, targets) -> loss`: the training forward (BN on
    batch statistics), the symmetric CE, backward, one update."""

    def step(images: torch.Tensor, text: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad()
        img_f, txt_f, scale = model(images, text, train=True)
        loss = clip_symmetric_ce(img_f, txt_f, scale, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class CLIPPretrainer:
    def __init__(self, cfg, device="cuda"):
        from fudanocr_tpu_torch.apps.sr_common import seeded
        from fudanocr_tpu_torch.data.rec_dataset import (RecLMDBDataset,
                                                         SyntheticCharDataset)

        self.cfg = cfg
        self.codec = radical_codec(cfg.alphabet_path or None,
                                   cfg.decompose_path or None)
        self.charset = sorted(self.codec.decomposition)
        size = (cfg.imageH, cfg.imageW)
        if cfg.train_dataset:
            self.train_data = RecLMDBDataset(cfg.train_dataset.split(","),
                                             size)
            self.test_data = RecLMDBDataset(cfg.test_dataset.split(","), size)
        else:
            cs = "".join(self.charset)
            self.train_data = SyntheticCharDataset(cs, cfg.synthetic_samples,
                                                   size)
            self.test_data = SyntheticCharDataset(
                cs, max(cfg.synthetic_samples // 4, 8), size, seed=1)
        self.model = seeded(lambda: CCRCLIP(
            vocab_size=self.codec.num_classes, context_length=cfg.max_len,
            transformer_layers=cfg.transformer_layers), 0, device)
        self.device = next(self.model.parameters()).device
        self.lr = float(cfg.lr)
        self.optimizer = clip_adam(self.model.parameters(),
                                   lambda count: self.lr)
        self.train_step = make_clip_train_step(self.model, self.optimizer)
        self.best_acc = -1.0

    def text_tokens(self, labels) -> torch.Tensor:
        """The text input: the raw radical sequence with its terminator
        (utils.py:55-68), i.e. the dense target grid, not shifted right."""
        _, gt, _ = self.codec.encode(labels, self.cfg.max_len)
        return torch.from_numpy(gt).to(self.device).long()

    @torch.no_grad()
    def charset_text_features(self, chunk: int = 100) -> torch.Tensor:
        """(len(charset), embed_dim) text features, on the device."""
        return torch.cat([
            self.model.encode_text(self.text_tokens(
                self.charset[s:s + chunk]))
            for s in range(0, len(self.charset), chunk)])

    def train(self):
        it = 0
        for epoch in range(self.cfg.epoch):
            for images, labels in self.train_data.batches(self.cfg.batch):
                loss = self.train_step(
                    torch.from_numpy(images).to(self.device),
                    self.text_tokens(labels),
                    torch.from_numpy(first_occurrence_targets(labels))
                    .to(self.device))
                it += 1
                if it % 50 == 0:
                    log.info("epoch %d iter %d loss %.4f", epoch, it,
                             float(loss))
            # x0.8 every 2 epochs after 10 (main.py:113-116)
            if (epoch + 1) > 10 and (epoch + 1) % 2 == 0:
                self.lr *= 0.8
            self.evaluate(epoch)

    @torch.no_grad()
    def evaluate(self, epoch: int = 0) -> Dict[str, float]:
        tf = self.charset_text_features().float()
        tf = tf / tf.norm(dim=1, keepdim=True)
        correct, total = 0, 0
        for images, labels in self.test_data.batches(self.cfg.batch):
            img_f = self.model.encode_image(
                torch.from_numpy(images).to(self.device)).float()
            img_f = img_f / img_f.norm(dim=1, keepdim=True)
            idx = (img_f @ tf.T).argmax(1).cpu().numpy()
            for i, lab in enumerate(labels):
                correct += int(self.charset[idx[i]] == lab)
                total += 1
        acc = correct / max(total, 1)
        log.info("zero-shot retrieval acc @epoch %d: %.4f (%d/%d)", epoch,
                 acc, correct, total)
        if self.cfg.ckpt_dir and acc >= self.best_acc:
            self.best_acc = acc
            ckpt_lib.save(os.path.join(self.cfg.ckpt_dir, "best"),
                          {"state_dict": self.model.state_dict(),
                           "optimizer": self.optimizer.state_dict()},
                          meta={"epoch": epoch, "acc": acc})
        return {"acc": acc}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="CCR-CLIP pretraining")
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)
    cfg = merge_cli_overrides(DEFAULT_CONFIG, args.options)
    from fudanocr_tpu_torch.apps.sr_common import resolve_device
    trainer = CLIPPretrainer(cfg, resolve_device(args.device))
    if cfg.test_only:
        res = trainer.evaluate(0)
    else:
        trainer.train()
        res = {"acc": trainer.best_acc}
    print(res)
    return res


if __name__ == "__main__":
    main()
