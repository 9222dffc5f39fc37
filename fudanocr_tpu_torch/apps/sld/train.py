"""Stroke-level decomposition (IJCAI-21) entry point (port of
fudanocr_tpu/apps/sld/train.py).

stroke-level-decomposition/train.py + config.py: mode 'character' or
'stroke', Adadelta lr 1.0, batch 32, 32x32 inputs. Stroke mode decodes
5-class stroke strings ('<12345$'), Levenshtein-rectifies them to the
nearest legal decomposition and disambiguates characters that share one
decomposition by conv-feature matching against rendered templates
(util.py:188-275).

    python -m fudanocr_tpu_torch.apps.sld.train [--options k=v ...] \\
        [--device cuda]

Without `decompose_table` a seeded synthetic stroke table over A-Z, 0-9
(JAX's) and `SyntheticCharDataset` stand in for the reference's files.
Departure from the JAX app: the confusable-matched evaluation writes
`ckpt_dir/best/` on its best accuracy as the trainer's own evaluation
does (JAX's writes nothing). `resume` is in the config and unread, as in
JAX. `main` returns the final evaluation's dict. Under torchrun
(`torchrun --nproc_per_node N -m fudanocr_tpu_torch.apps.sld.train ...`) it
trains and evaluates data-parallel, `batch` being the global batch
(train/ctr.py).
"""

from __future__ import annotations

import argparse
import logging
import random
import string

import numpy as np
import torch

from fudanocr_tpu_torch.core.config import Config, merge_cli_overrides

log = logging.getLogger("fudanocr_tpu_torch.sld")

DEFAULT_CONFIG = Config({
    "exp_name": "sld",
    "epoch": 1,
    "lr": 1.0,
    "mode": "stroke",           # character / stroke
    "batch": 32,
    "val_frequency": 1000,
    "test_only": False,
    "resume": "",
    "train_dataset": "",        # comma-separated LMDB roots; empty=synthetic
    "test_dataset": "",
    "weight_decay": False,
    "image_size": 32,
    "alphabet": 3755,
    "decompose_table": "",      # decompose-stroke-3755.txt path
    "ckpt_dir": "./ckpt/sld",
    "max_len": 30,
    "synthetic_samples": 64,
    # the reference's model (transformer.py:77: ResNet [3,4,6,3])
    "encoder_layers": [3, 4, 6, 3],
    "d_embed": 512,
    "d_model": 1024,
    "d_ff": 2048,
    "encoder_width_div": 1,     # small test models only
})

STROKE_ALPHABET = "<12345$"


def synthetic_stroke_table():
    """JAX's seeded stand-in for decompose-stroke-3755.txt: each of A-Z,
    0-9 gets 2-6 strokes from '12345', drawn from random.Random(0)."""
    rng = random.Random(0)
    return {ch: "".join(rng.choice("12345")
                        for _ in range(rng.randint(2, 6)))
            for ch in string.ascii_uppercase + string.digits}


def build_codec_and_data(cfg):
    """(codec, rectifier, train set, test set) from the config."""
    from fudanocr_tpu_torch.data.codecs import (SequenceCodec,
                                                load_decomposition_table)
    from fudanocr_tpu_torch.data.rec_dataset import (RecLMDBDataset,
                                                     SyntheticCharDataset)
    from fudanocr_tpu_torch.eval.levenshtein import SequenceRectifier

    if cfg.decompose_table:
        table = load_decomposition_table(cfg.decompose_table, "sld")
    else:
        log.warning("no decompose_table configured; generating a "
                    "synthetic stroke table (tests/demo only)")
        table = synthetic_stroke_table()

    if cfg.mode not in ("stroke", "character"):
        raise ValueError(f"mode must be 'stroke' or 'character', "
                         f"got {cfg.mode!r}")
    if cfg.mode == "stroke":
        codec = SequenceCodec(STROKE_ALPHABET, table, terminator="$")
        rectifier = SequenceRectifier(sorted(set(table.values())))
    else:
        codec = SequenceCodec(["<"] + sorted(table) + ["$"], None,
                              terminator="$")
        rectifier = None

    size = (cfg.image_size, cfg.image_size)
    if cfg.train_dataset:
        train = RecLMDBDataset(cfg.train_dataset.split(","), size)
        test = RecLMDBDataset(cfg.test_dataset.split(","), size)
    else:
        charset = "".join(sorted(table))
        train = SyntheticCharDataset(charset, cfg.synthetic_samples, size)
        test = SyntheticCharDataset(charset, max(cfg.synthetic_samples // 4,
                                                 8), size, seed=1)
    return codec, rectifier, train, test


def build_model(cfg, vocab: int, device, kernels: bool = True,
                dtype: torch.dtype = torch.float32):
    """The SLD OCRTransformer (stem pool only), from seed 0, on `device`,
    computing in `dtype` (the app trains in float32, as JAX's does; JAX's
    bench_ctr.py runs the model in bf16)."""
    from fudanocr_tpu_torch.apps.sr_common import seeded
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer

    return seeded(lambda: OCRTransformer(
        vocab=vocab, num_in=3, layers=tuple(cfg.encoder_layers), num_heads=4,
        d_embed=cfg.d_embed, d_model=cfg.d_model, d_ff=cfg.d_ff,
        stage1_pool=False, encoder_width_div=cfg.encoder_width_div,
        kernels=kernels, dtype=dtype), 0, device)


@torch.no_grad()
def _encode_chunks(model, images: np.ndarray, device,
                   chunk: int = 64) -> torch.Tensor:
    """model.encode over `images` in chunks of 64 -> (N, T, C) on the
    device."""
    return torch.cat([model.encode(torch.from_numpy(images[s:s + chunk])
                                   .to(device))
                      for s in range(0, len(images), chunk)])


def attach_confusable_matching(trainer, codec, cfg) -> None:
    """Replace `trainer.evaluate` by the per-CHARACTER accuracy of
    sld/util.py:188-275: a decode that rectifies to a decomposition shared
    by several characters picks the one whose template's conv features
    (`model.encode`, gallery encoded in chunks of 64) are nearest the
    probe's by mean squared distance. The distances are taken on the
    device, one (B, N) matrix per batch, copied once. The templates come
    from `apps/oictr/train.render_char_templates`."""
    from fudanocr_tpu_torch.apps.oictr.train import render_char_templates

    table = codec.decomposition
    seq_to_chars = {}
    for ch, seq in table.items():
        seq_to_chars.setdefault(seq, []).append(ch)
    charset = sorted(table)
    col = {c: j for j, c in enumerate(charset)}
    templates = render_char_templates(charset, cfg.image_size)
    model, device = trainer.model, trainer.device

    def evaluate(it: int = 0):
        if not trainer.mesh.active:
            return {}
        gallery = _encode_chunks(
            model, np.stack([templates[c] for c in charset]), device)
        total, correct = 0, 0
        for images, labels in trainer.batches(trainer.eval_data):
            preds = trainer.decode_batch(images)
            probe = _encode_chunks(model, images, device)
            with torch.no_grad():
                dist = torch.stack([((probe - g) ** 2).flatten(1).mean(1)
                                    for g in gallery], 1).cpu().numpy()
            for i, (p, gt_char) in enumerate(zip(preds, labels)):
                total += 1
                if p != table.get(gt_char, ""):
                    continue
                cands = seq_to_chars.get(p, [])
                if len(cands) <= 1:
                    correct += int(bool(cands) and cands[0] == gt_char)
                    continue
                scores = [dist[i, col[c]] for c in cands]
                correct += int(cands[int(np.argmin(scores))] == gt_char)
        correct, total = trainer.count_correct(correct, total)
        acc = correct / max(total, 1)
        log.info("confusable-matched eval @%d: acc %.4f (%d/%d)", it, acc,
                 correct, total)
        if trainer.ckpt_dir and acc >= trainer.best_acc:
            trainer.best_acc = acc
            trainer.save_best({"step": trainer.step, "acc": acc})
        return {"acc": acc}

    trainer.evaluate = evaluate


def build_trainer(cfg, device, kernels: bool = True):
    """The CTRTrainer of the config on `device` (confusable matching
    attached in stroke mode)."""
    from fudanocr_tpu_torch.train.ctr import CTRTrainer

    codec, rectifier, train_data, test_data = build_codec_and_data(cfg)
    model = build_model(cfg, codec.num_classes, device, kernels)
    trainer = CTRTrainer(model, codec, train_data, test_data,
                         batch_size=cfg.batch, lr=cfg.lr,
                         weight_decay=1e-4 if cfg.weight_decay else 0.0,
                         epochs=cfg.epoch, eval_every=cfg.val_frequency,
                         max_len=cfg.max_len, rectifier=rectifier,
                         ckpt_dir=cfg.ckpt_dir)
    if cfg.mode == "stroke":
        attach_confusable_matching(trainer, codec, cfg)
    return trainer


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description="stroke-level decomposition CTR")
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)
    cfg = merge_cli_overrides(DEFAULT_CONFIG, args.options)

    from fudanocr_tpu_torch.apps.sr_common import distributed_device
    trainer = build_trainer(cfg, distributed_device(args.device))
    if cfg.test_only:
        res = trainer.evaluate(0)
    else:
        # the reference's saver() + overwrite prompt (sld/util.py:144-173)
        from fudanocr_tpu_torch.core.logging import guard_run_dir
        if not guard_run_dir(cfg.ckpt_dir, sources=[__file__]):
            return None
        trainer.train()
        res = trainer.evaluate(-1)
    print(res)
    return res


if __name__ == "__main__":
    main()
