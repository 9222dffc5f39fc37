"""ACPM (augmented character profile matching) entry point (port of
fudanocr_tpu/apps/acpm/train.py).

character-profile-matching/train.py + config.py: the radical decoder's
CE, the printed-template feature MSE, the radical-count loss (L1 or CE),
the stroke-orientation-count MSE and the stroke-length MSE (weight 0.01
when pretraining, else 1 against ground truth normalised to the
predicted sums); Adadelta lr 1.0; test-time profile matching over
Levenshtein candidates (`eval/profile_matching.py`).

    python -m fudanocr_tpu_torch.apps.acpm.train [--options k=v ...] \\
        [--device cuda]

The profile tables ({3755,ctw}_rad_num / stroke_num / stroke_len,
decompose.txt) come from configured paths; without them JAX's seeded
synthetic profile system and `SyntheticCharDataset` stand in. The print
templates are `apps/oictr/train.render_char_templates`'s, drawn with the
port's bitmap font (ROADMAP C26). One device; `best/` holds the port's
payload (`core/checkpoint`, C28). `main` returns the final evaluation.

At the default config the synthetic test set holds max(64 // 4, 8) = 16
samples, fewer than a batch of 32, and `batches` drops the partial
batch: the evaluation decodes nothing and reports acc 0 over 0, as JAX's
does (ROADMAP C31).
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import string
from typing import Dict

import numpy as np
import torch

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.core.config import Config, merge_cli_overrides
from fudanocr_tpu_torch.train.ctr import masked_token_ce
from fudanocr_tpu_torch.train.state import ScheduledOptimizer

log = logging.getLogger("fudanocr_tpu_torch.acpm")

DEFAULT_CONFIG = Config({
    "epoch": 1, "lr": 1.0, "batch": 32, "val_frequency": 1000,
    "image_size": 32, "max_len": 12,
    "train_dataset": "", "test_dataset": "",
    "decompose_path": "", "rad_num_path": "", "stroke_num_path": "",
    "stroke_len_path": "",
    "encoder": "resnet", "rn_loss": "L1", "stn": False, "pretrain": False,
    "candidate_search_range": 0,
    "ckpt_dir": "./ckpt/acpm", "synthetic_samples": 64, "test_only": False,
    # "" = the reference's depth (3, 4, 6, 3); small test models "1,1,1,1"
    "encoder_layers": "",
    # the reference: d_model 1024, width_div 1
    "d_model": 1024, "encoder_width_div": 1,
})


def build_profiles(cfg):
    """-> (charset, decomposition dict, r_num, s_num, s_len tables)."""
    if cfg.decompose_path:
        from fudanocr_tpu_torch.data.codecs import load_decomposition_table
        table = {k: v.replace(" ", "") for k, v in
                 load_decomposition_table(cfg.decompose_path,
                                          "colon").items()}
        charset = sorted(table.keys())

        def load_vec(path, dim):
            rows = {}
            with open(path, encoding="utf-8") as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) >= dim + 1:
                        rows[parts[0]] = np.asarray(
                            [float(x) for x in parts[1:dim + 1]], np.float32)
            return rows

        r_num = {ch: float(len(table[ch])) for ch in charset}
        s_num = (load_vec(cfg.stroke_num_path, 4) if cfg.stroke_num_path
                 else {ch: np.ones(4, np.float32) for ch in charset})
        s_len = (load_vec(cfg.stroke_len_path, 4) if cfg.stroke_len_path
                 else {ch: np.ones(4, np.float32) for ch in charset})
        if cfg.rad_num_path:
            with open(cfg.rad_num_path, encoding="utf-8") as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) >= 2:
                        r_num[parts[0]] = float(parts[1])
    else:
        rng = random.Random(0)
        radicals = "abcdefghij"
        charset = list(string.ascii_uppercase + string.digits)
        table = {ch: "".join(rng.choice(radicals)
                             for _ in range(rng.randint(2, 5)))
                 for ch in charset}
        r_num = {ch: float(len(table[ch])) for ch in charset}
        s_num = {ch: np.asarray([rng.randint(1, 5) for _ in range(4)],
                                np.float32) for ch in charset}
        s_len = {ch: np.asarray([rng.uniform(1, 4) for _ in range(4)],
                                np.float32) for ch in charset}
    return charset, table, r_num, s_num, s_len


def acpm_loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
              print_memory: torch.Tensor, rn_loss: str = "L1",
              pretrain: bool = False) -> torch.Tensor:
    """The five ACPM terms (JAX apps/acpm/train.py:138-177) of one training
    forward `out`; `print_memory` is the templates' memory, a constant."""
    decode_loss = masked_token_ce(out["pred"], batch["text_gt"],
                                  batch["lengths"])
    feature_loss = ((out["conv"].float() - print_memory.float()) ** 2).mean()
    if rn_loss == "L1":
        rn = (out["r_num"].float() - batch["r_num"]).abs().mean()
    else:
        logp = out["r_num"].clamp_min(1e-8).log()
        rn = -logp.gather(-1, batch["r_num"].long()[:, None]).mean()
    sn_loss = ((out["s_num"].float() - batch["s_num"]) ** 2).mean()
    s_len = out["s_len"].float()
    s_len_gt = batch["s_len"]
    if not pretrain:
        # the ground truth scaled to the predicted sums; the gradient flows
        # through the target too, as in JAX (no stop_gradient there)
        gt_sum = s_len_gt.sum(1, keepdim=True).clamp_min(1e-6)
        s_len_gt = s_len_gt / gt_sum * s_len.sum(1, keepdim=True)
    sl_loss = ((s_len - s_len_gt) ** 2).mean()
    return (decode_loss + feature_loss + rn + sn_loss
            + (0.01 if pretrain else 1.0) * sl_loss)


def make_acpm_train_step(model, optimizer: ScheduledOptimizer,
                         rn_loss: str = "L1", pretrain: bool = False):
    """`step(batch, generator) -> loss`: the print templates' memory, then
    the training forward, the ACPM objective, backward, one update.

    JAX encodes the templates with the BatchNorm statistics from before the
    step; a torch training forward moves them in place, so the templates
    are encoded first, in inference mode and without a gradient (JAX
    stop-gradients them)."""

    def step(batch, generator=None) -> torch.Tensor:
        optimizer.zero_grad()
        with torch.no_grad():
            print_memory = model.encode(batch["print_image"])
        out = model(batch["image"], batch["text_input"], train=True,
                    generator=generator)
        loss = acpm_loss(out, batch, print_memory, rn_loss, pretrain)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class ACPMTrainer:
    def __init__(self, cfg, device="cuda", kernels: bool = True):
        from fudanocr_tpu_torch.apps.oictr.train import render_char_templates
        from fudanocr_tpu_torch.apps.sr_common import seeded
        from fudanocr_tpu_torch.data.codecs import SequenceCodec
        from fudanocr_tpu_torch.data.rec_dataset import (RecLMDBDataset,
                                                         SyntheticCharDataset)
        from fudanocr_tpu_torch.models.rec.acpm import ACPM
        from fudanocr_tpu_torch.train.state import ctr_adadelta

        self.cfg = cfg
        self.charset, self.table, self.r_num, self.s_num, self.s_len = \
            build_profiles(cfg)
        radset = sorted({r for v in self.table.values() for r in v})
        self.codec = SequenceCodec(["<"] + radset + ["$"], self.table,
                                   terminator="$")
        self.legal_radicals = [self.table[ch] for ch in self.charset]
        # the printed templates (the reference's printstandard dirs)
        self.templates = render_char_templates(self.charset, cfg.image_size)

        size = (cfg.image_size, cfg.image_size)
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

        enc_layers = (tuple(int(x) for x in str(cfg.encoder_layers).split(","))
                      if cfg.encoder_layers else None)
        self.model = seeded(lambda: ACPM(
            vocab=self.codec.num_classes, encoder=cfg.encoder,
            rn_loss=cfg.rn_loss, stn=cfg.stn, d_model=cfg.d_model,
            encoder_layers=enc_layers,
            encoder_width_div=cfg.encoder_width_div, kernels=kernels),
            0, device)
        self.device = next(self.model.parameters()).device
        self.optimizer = ctr_adadelta(self.model.parameters(), cfg.lr)
        self.train_step = make_acpm_train_step(
            self.model, self.optimizer, cfg.rn_loss, cfg.pretrain)
        self.best_acc = -1.0

    def host_batch(self, images, labels) -> Dict[str, np.ndarray]:
        text_input, text_gt, lengths = self.codec.encode(labels,
                                                         self.cfg.max_len)
        return {"image": np.asarray(images, np.float32),
                "print_image": np.stack([self.templates[l] for l in labels]),
                "text_input": text_input, "text_gt": text_gt,
                "lengths": lengths,
                "r_num": np.asarray([self.r_num[l] for l in labels],
                                    np.float32),
                "s_num": np.stack([self.s_num[l] for l in labels]),
                "s_len": np.stack([self.s_len[l] for l in labels])}

    def device_batch(self, images, labels) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.host_batch(images, labels).items()}

    def train(self):
        from fudanocr_tpu_torch.train.seg import iteration_generator

        for epoch in range(self.cfg.epoch):
            for images, labels in self.train_data.batches(self.cfg.batch):
                loss = self.train_step(
                    self.device_batch(images, labels),
                    iteration_generator(0, self.optimizer.count,
                                        self.device))
                it = self.optimizer.count
                if it % 50 == 0:
                    log.info("epoch %d iter %d loss %.4f", epoch, it,
                             float(loss))
                if it % self.cfg.val_frequency == 0:
                    self.evaluate(it)

    @torch.no_grad()
    def profile_features(self, chunk: int = 64) -> Dict[int, np.ndarray]:
        """Each character's template memory (encoded in chunks of 64), by
        charset index, on the host."""
        prints = np.stack([self.templates[ch] for ch in self.charset])
        mem = torch.cat([self.model.encode(torch.from_numpy(
            prints[s:s + chunk]).to(self.device))
            for s in range(0, len(prints), chunk)]).float().cpu().numpy()
        return dict(enumerate(mem))

    @torch.no_grad()
    def predict(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """A test batch's greedy-decoded ids and, from one forward on zero
        text, its memory and profile heads, on the host."""
        from fudanocr_tpu_torch.models.rec.ocr_transformer import \
            greedy_decode

        x = torch.from_numpy(images).to(self.device)
        ids = greedy_decode(self.model, x, self.cfg.max_len)
        out = self.model(x, torch.zeros(len(images), self.cfg.max_len,
                                        dtype=torch.long,
                                        device=self.device))
        res = {k: out[k].float().cpu().numpy()
               for k in ("conv", "r_num", "s_num", "s_len")}
        res["ids"] = ids.cpu().numpy()
        return res

    def evaluate(self, it: int = 0) -> Dict[str, float]:
        from fudanocr_tpu_torch.eval.profile_matching import (
            get_candidates, select_candidate)
        from fudanocr_tpu_torch.train.ctr import ids_to_strings

        cfg = self.cfg
        profile_features = self.profile_features()
        profile_r = [self.r_num[ch] for ch in self.charset]
        profile_sn = [self.s_num[ch] for ch in self.charset]
        profile_sl = [self.s_len[ch] for ch in self.charset]
        correct, total = 0, 0
        for images, labels in self.test_data.batches(cfg.batch):
            out = self.predict(images)
            preds = ids_to_strings(out["ids"], self.codec.alphabet, "$")
            for b, (pred, lab) in enumerate(zip(preds, labels)):
                cands = get_candidates(pred, self.legal_radicals,
                                       cfg.candidate_search_range)
                if len(cands) == 1:
                    pick = cands[0]
                else:
                    pick = select_candidate(
                        cands, out["conv"][b], float(out["r_num"][b]),
                        out["s_num"][b], out["s_len"][b], profile_features,
                        profile_r, profile_sn, profile_sl)
                correct += int(self.charset[pick] == lab)
                total += 1
        acc = correct / max(total, 1)
        log.info("eval @%d: acc %.4f (%d/%d)", it, acc, correct, total)
        if cfg.ckpt_dir and acc >= self.best_acc:
            self.best_acc = acc
            ckpt_lib.save(os.path.join(cfg.ckpt_dir, "best"),
                          {"state_dict": self.model.state_dict(),
                           "optimizer": self.optimizer.state_dict(),
                           "step": self.optimizer.count},
                          meta={"step": self.optimizer.count, "acc": acc})
        return {"acc": acc}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="ACPM radical CCR")
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)
    cfg = merge_cli_overrides(DEFAULT_CONFIG, args.options)
    from fudanocr_tpu_torch.apps.sr_common import resolve_device
    trainer = ACPMTrainer(cfg, resolve_device(args.device))
    if cfg.test_only:
        res = trainer.evaluate(0)
    else:
        trainer.train()
        res = trainer.evaluate(-1)
    print(res)
    return res


if __name__ == "__main__":
    main()
