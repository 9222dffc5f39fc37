"""Orientation-independent CTR entry point (port of
fudanocr_tpu/apps/oictr/train.py).

orientation-independent-CTR/train.py + data/lmdbReader.py:80-133:

* the aspect-ratio rule (1.5 * w >= h horizontal, else vertical, rotated
  into the horizontal frame) gives (images, is_v) from LMDB data;
  synthetic characters are horizontal;
* loss = CE(decode) + 5 * (MSE(raw reconstruction, char template) +
  MSE(direction-swapped reconstruction, rotated template)) +
  CE(direction);
* the char templates (reference: SIMSUN renders and their rot90,
  util.py:90-109) are drawn with the port's bitmap font;
* decay 1e-4 + Adadelta(lr) under cosine warm restarts with T_0 = 10
  epochs of updates.

    python -m fudanocr_tpu_torch.apps.oictr.train [--options k=v ...] \\
        [--device cuda]

One device; `best/` holds the port's payload and JAX's state.msgpack
(params, batch_stats), `core/checkpoint`.
"""

from __future__ import annotations

import argparse
import logging
import os
import string
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.core.config import Config, merge_cli_overrides
from fudanocr_tpu_torch.data.glyphs import draw_text
from fudanocr_tpu_torch.train.ctr import masked_token_ce
from fudanocr_tpu_torch.train.state import ScheduledOptimizer
from fudanocr_tpu_torch.utils.weights import jax_variables

log = logging.getLogger("fudanocr_tpu_torch.oictr")

DEFAULT_CONFIG = Config({
    "epoch": 1, "lr": 1.0, "batch": 32, "val_frequency": 1000,
    "imageH": 32, "imageW": 128, "max_len": 16,
    "train_dataset": "", "test_dataset": "", "alphabet_path": "",
    "ckpt_dir": "./ckpt/oictr", "synthetic_samples": 64,
    "test_only": False,
    # "" = the reference's depth (3, 4, 6); small test models pass "1,1,1"
    "encoder_layers": "",
    # the reference: d_model 512, d_embed 256, width_div 1
    "d_model": 512, "d_embed": 256, "encoder_width_div": 1,
})

TEMPLATE = 32   # the reconstructor's output side


def render_char_templates(charset, size: int = 32) -> Dict[str, np.ndarray]:
    """Stand-ins for the SIMSUN char templates: each character drawn black
    at (size // 3, size // 3) on a white size x size RGB canvas, in
    [-1, 1] float32. JAX draws PIL's default font there; the port draws
    its bitmap font (`data/glyphs.py`), so the glyph pixels differ and
    every other pixel is equal (ROADMAP C17)."""
    out = {}
    for ch in charset:
        img = np.full((size, size, 3), 255, np.uint8)
        draw_text(img, (size // 3, size // 3), ch, 0)
        out[ch] = img.astype(np.float32) / 127.5 - 1.0
    return out


def swap_indices(is_v_char: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """For each valid char, the index of a valid char of the OPPOSITE
    orientation (cyclic, transformer.py:466-483); its own index if there
    is none."""
    n = len(is_v_char)
    hor = [i for i in range(n) if valid[i] and is_v_char[i] == 0]
    ver = [i for i in range(n) if valid[i] and is_v_char[i] == 1]
    out = np.arange(n, dtype=np.int32)
    if hor and ver:
        for j, i in enumerate(hor):
            out[i] = ver[j % len(ver)]
        for j, i in enumerate(ver):
            out[i] = hor[j % len(hor)]
    return out


def oictr_loss(model, out, batch) -> torch.Tensor:
    """The OI-CTR objective of one training forward `out`."""
    loss_rec = masked_token_ce(out["pred"], batch["text_gt"],
                               batch["lengths"])
    loss_dir = F.cross_entropy(out["direction_logits"].float(),
                               batch["is_v"].long())
    b, l = batch["text_gt"].shape
    cm = out["char_maps"].reshape(b * l, model.d_model, 4)
    df = out["direction_feat"].repeat_interleave(l, 0)
    new = model.reconstruct(cm, df[batch["swap_idx"].long()])
    m = batch["char_valid"].float()[:, None, None, None]
    denom = (m.sum() * TEMPLATE * TEMPLATE * 3).clamp_min(1.0)
    loss_raw = (((out["raw_imgs"] - batch["raw_gt"]) ** 2) * m).sum() / denom
    loss_new = (((new - batch["new_gt"]) ** 2) * m).sum() / denom
    return loss_rec + 5.0 * (loss_raw + loss_new) + loss_dir


def make_oictr_train_step(model, optimizer: ScheduledOptimizer):
    """`step(batch, generator) -> loss`: the training forward, the OI-CTR
    objective, backward, one update."""

    def step(batch, generator=None) -> torch.Tensor:
        optimizer.zero_grad()
        out = model(batch["image"], batch["text_input"], train=True,
                    generator=generator)
        loss = oictr_loss(model, out, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class OICTRTrainer:
    def __init__(self, cfg, device="cuda", kernels: bool = True):
        from fudanocr_tpu_torch.apps.sr_common import seeded
        from fudanocr_tpu_torch.data.codecs import SequenceCodec
        from fudanocr_tpu_torch.data.rec_dataset import (
            OrientationLMDBDataset, SyntheticCharDataset)
        from fudanocr_tpu_torch.models.rec.oictr import OICTR
        from fudanocr_tpu_torch.train.schedules import cosine_warm_restarts
        from fudanocr_tpu_torch.train.state import ctr_adadelta

        self.cfg = cfg
        if cfg.alphabet_path:
            with open(cfg.alphabet_path, encoding="utf-8") as f:
                charset = [ln.rstrip("\n") for ln in f if ln.strip()]
        else:
            charset = list(string.ascii_uppercase + string.digits)
        self.charset = charset
        self.codec = SequenceCodec(["<"] + charset + ["$"], None,
                                   terminator="$")
        self.templates = render_char_templates(charset)

        size = (cfg.imageH, cfg.imageW)
        if cfg.train_dataset:
            self.train_data = OrientationLMDBDataset(
                cfg.train_dataset.split(","), size)
            self.test_data = OrientationLMDBDataset(
                cfg.test_dataset.split(","), size)
        else:
            cs = "".join(charset)
            self.train_data = SyntheticCharDataset(cs, cfg.synthetic_samples,
                                                   size)
            self.test_data = SyntheticCharDataset(
                cs, max(cfg.synthetic_samples // 4, 8), size, seed=1)

        enc_layers = (tuple(int(x) for x in str(cfg.encoder_layers).split(","))
                      if cfg.encoder_layers else None)
        self.model = seeded(lambda: OICTR(
            vocab=self.codec.num_classes, d_model=cfg.d_model,
            d_embed=cfg.d_embed, image_size=size, encoder_layers=enc_layers,
            encoder_width_div=cfg.encoder_width_div, kernels=kernels),
            0, device)
        self.device = next(self.model.parameters()).device
        # Adadelta + CosineAnnealingWarmRestarts(T_0=10 epochs)
        # (orientation-independent-CTR/train.py:29-30)
        self.steps_per_epoch = max(len(self.train_data) // cfg.batch, 1)
        self.optimizer = ctr_adadelta(
            self.model.parameters(),
            cosine_warm_restarts(cfg.lr, 10 * self.steps_per_epoch),
            weight_decay=1e-4)
        self.train_step = make_oictr_train_step(self.model, self.optimizer)
        self.best_acc = -1.0

    def host_batch(self, images, labels, is_v=None) -> Dict[str, np.ndarray]:
        """The step's arrays: codec ids, orientation, per-char validity,
        the templates each char's raw and swapped reconstructions match
        (rotated for the other orientation), and the swap gather."""
        text_input, text_gt, lengths = self.codec.encode(labels,
                                                         self.cfg.max_len)
        b, l = text_gt.shape
        is_v = (np.zeros((b,), np.int32) if is_v is None
                else np.asarray(is_v, np.int32))
        char_valid = np.zeros((b, l), np.float32)
        raw_gt = np.zeros((b * l, TEMPLATE, TEMPLATE, 3), np.float32)
        new_gt = np.zeros_like(raw_gt)
        is_v_char = np.zeros((b * l,), np.int32)
        for i, lab in enumerate(labels):
            for j, ch in enumerate(lab[:l]):
                if j >= lengths[i] - 1 or ch not in self.templates:
                    continue
                char_valid[i, j] = 1.0
                t = self.templates[ch]
                rot = np.rot90(t, 1, (0, 1))
                raw_gt[i * l + j], new_gt[i * l + j] = (
                    (t, rot) if is_v[i] == 0 else (rot, t))
                is_v_char[i * l + j] = is_v[i]
        swap = swap_indices(is_v_char, char_valid.reshape(-1))
        return {"image": np.asarray(images, np.float32),
                "text_input": text_input, "text_gt": text_gt,
                "lengths": lengths, "is_v": is_v,
                "char_valid": char_valid.reshape(-1), "raw_gt": raw_gt,
                "new_gt": new_gt, "swap_idx": swap}

    def device_batch(self, *batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.host_batch(*batch).items()}

    def train(self):
        from fudanocr_tpu_torch.train.seg import iteration_generator

        for epoch in range(self.cfg.epoch):
            for batch in self.train_data.batches(self.cfg.batch):
                loss = self.train_step(
                    self.device_batch(*batch),
                    iteration_generator(0, self.optimizer.count,
                                        self.device))
                it = self.optimizer.count
                if it % 50 == 0:
                    log.info("epoch %d iter %d loss %.4f", epoch, it,
                             float(loss))
                if it % self.cfg.val_frequency == 0:
                    self.evaluate(it)

    def decode(self, images) -> list:
        """Greedy-decoded strings of a host batch (ids copied once)."""
        from fudanocr_tpu_torch.models.rec.ocr_transformer import \
            greedy_decode
        from fudanocr_tpu_torch.train.ctr import ids_to_strings

        ids = greedy_decode(self.model,
                            torch.from_numpy(images).to(self.device),
                            self.cfg.max_len).cpu().numpy()
        return ids_to_strings(ids, self.codec.alphabet, "$")

    def evaluate(self, it: int = 0):
        correct, total = 0, 0
        for batch in self.test_data.batches(self.cfg.batch):
            for pred, lab in zip(self.decode(batch[0]), batch[1]):
                correct += int(pred == lab)
                total += 1
        acc = correct / max(total, 1)
        log.info("eval @%d: acc %.4f (%d/%d)", it, acc, correct, total)
        if self.cfg.ckpt_dir and acc >= self.best_acc:
            self.best_acc = acc
            ckpt_lib.save(os.path.join(self.cfg.ckpt_dir, "best"),
                          {"state_dict": self.model.state_dict(),
                           "optimizer": self.optimizer.state_dict(),
                           "step": self.optimizer.count},
                          meta={"step": self.optimizer.count, "acc": acc},
                          jax_tree=jax_variables(self.model))
        return {"acc": acc}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="orientation-independent CTR")
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)
    cfg = merge_cli_overrides(DEFAULT_CONFIG, args.options)
    from fudanocr_tpu_torch.apps.sr_common import resolve_device
    trainer = OICTRTrainer(cfg, resolve_device(args.device))
    if cfg.test_only:
        res = trainer.evaluate(0)
    else:
        trainer.train()
        res = trainer.evaluate(-1)
    print(res)
    return res


if __name__ == "__main__":
    main()
