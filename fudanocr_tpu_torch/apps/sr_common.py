"""Shared wiring for the two SR apps, scene-text-telescope and text-gestalt
(port of fudanocr_tpu/apps/sr_common.py).

The reference's entry shape, `main.py --arch tbsrn --STN --text_focus
[--test|--demo]` over config/super_resolution.yaml, on the port's YAML
reader (`core/config.py`). With no dataset directories configured the
apps train on the synthetic TextZoom generator, so every path runs with
no data on disk. `--device` (default "cuda") places the models; a card
that is missing raises, nothing falls back to the CPU.

TRAIN.workers (default 8, the reference's DataLoader workers) forked
processes read, decode and collate the training batches
(`train/sr.SRTrainer`'s `num_workers`; 0 feeds from the main thread).

Every model is built on the CPU from a seed and then moved: the SR model
from TRAIN.manualSeed, the frozen text-focus oracle from 0 and the CRNN
evaluator from 1 (the JAX apps' PRNG keys), so two runs of an app, on any
device, start from the same weights. A pretrained oracle
(TRAIN.VAL.oracle_checkpoint) and `--resume` read checkpoints in the JAX
package's format (`core/checkpoint.py`), so models trained with either
package load in both.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
from typing import Callable, Optional

import torch

from fudanocr_tpu_torch.core.config import (Config, load_config,
                                            merge_cli_overrides)

log = logging.getLogger("fudanocr_tpu_torch")

DEFAULTS = Config({
    "TRAIN": {
        "train_data_dir": [], "batch_size": 64, "width": 128, "height": 32,
        "epochs": 2, "lr": 1e-4, "beta1": 0.5, "manualSeed": 1234,
        "max_len": 100, "down_sample_scale": 2, "ckpt_dir": "./ckpt/",
        "synthetic_samples": 512, "workers": 8,
        "displayInterval": 50, "saveInterval": 200, "voc_type": "all",
        "VAL": {"val_data_dir": [], "valInterval": 1000,
                "crnn_pretrained": "", "n_vis": 10, "vis_dir": "demo"},
    },
    "TEST": {"checkpoint": "", "test_data_dir": []},
})
BASELINES = ("srcnn", "srresnet", "edsr", "rdn", "esrgan")
ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"


def build_argparser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--arch", default="tbsrn",
                   choices=["tbsrn", "tsrn", *BASELINES])
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--test", action="store_true")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--STN", action="store_true")
    p.add_argument("--mask", action="store_true")
    p.add_argument("--text_focus", action="store_true")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--srb", type=int, default=5)
    p.add_argument("--hd_u", type=int, default=32)
    p.add_argument("--resume", type=str, default="",
                   help="a best.pt or a checkpoint directory in the JAX "
                   "package's format to load, or 'auto' for "
                   "ckpt_dir/best.pt (ckpt_dir/best/ without one)")
    p.add_argument("--options", nargs="*", default=[],
                   help="dotted-key config overrides, e.g. TRAIN.lr=2.0e-4")
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (default: the card)")
    return p


def load_app_config(args) -> Config:
    """DEFAULTS, the YAML's top-level keys over them (each replaces the
    default's whole subtree, as in the JAX app), then `--options`,
    `--batch_size` and `--epochs`."""
    cfg = DEFAULTS
    if args.config and os.path.exists(args.config):
        cfg = Config({**copy.deepcopy(DEFAULTS).to_dict(),
                      **load_config(args.config).to_dict()})
    cfg = merge_cli_overrides(cfg, args.options)
    if args.batch_size:
        cfg.TRAIN.batch_size = args.batch_size
    if args.epochs:
        cfg.TRAIN.epochs = args.epochs
    return cfg


def resolve_device(name) -> torch.device:
    """The `--device`; a CUDA device without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    return dev


def seeded(build: Callable[[], torch.nn.Module], seed: int,
           device) -> torch.nn.Module:
    """`build()` under torch's generator seeded with `seed` (the global
    generator's state is restored after), on the CPU, then moved to
    `device` (a missing card raises)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = build()
    return module.to(device)


def build_sr_model(args, cfg, device="cuda") -> torch.nn.Module:
    """TBSRN or TSRN from the flags and config, from TRAIN.manualSeed, on
    `device` (a missing card raises). The SR baselines come with ROADMAP
    A6."""
    from fudanocr_tpu_torch.models import sr as sr_models

    kw = dict(scale_factor=cfg.TRAIN.down_sample_scale,
              width=cfg.TRAIN.width, height=cfg.TRAIN.height,
              mask=args.mask, stn=args.STN, srb_nums=args.srb,
              hidden_units=args.hd_u)
    if args.arch == "tbsrn":
        return seeded(lambda: sr_models.TBSRN(**kw), cfg.TRAIN.manualSeed,
                      device)
    if args.arch == "tsrn":
        return seeded(lambda: sr_models.TSRN(**kw), cfg.TRAIN.manualSeed,
                      device)
    raise NotImplementedError(f"--arch {args.arch}: the SR baselines are "
                              "not ported yet (ROADMAP A6)")


def num_workers(cfg) -> int:
    """TRAIN.workers, the default's where the YAML's TRAIN leaves it
    out."""
    return int(cfg.TRAIN.get("workers", DEFAULTS.TRAIN.workers))


def build_dataset(data_dirs, cfg, train: bool):
    """A PairedLMDBDataset over `data_dirs`, or without any, the synthetic
    TextZoom generator (cfg.TRAIN.synthetic_samples items in training, a
    quarter, at least 8, in evaluation)."""
    if data_dirs:
        from fudanocr_tpu_torch.data.lmdb_dataset import PairedLMDBDataset
        return PairedLMDBDataset(data_dirs, voc_type=cfg.TRAIN.voc_type,
                                 batch_hw=(cfg.TRAIN.height, cfg.TRAIN.width),
                                 scale=cfg.TRAIN.down_sample_scale)
    from fudanocr_tpu_torch.data.synthetic import SyntheticTextZoom
    log.warning("no dataset dirs configured; using the synthetic TextZoom "
                "generator")
    n = cfg.TRAIN.synthetic_samples
    return SyntheticTextZoom(num_samples=n if train else max(n // 4, 8),
                             hr_size=(cfg.TRAIN.width, cfg.TRAIN.height),
                             scale=cfg.TRAIN.down_sample_scale)


def build_oracle(cfg, vocab: int, device) -> torch.nn.Module:
    """The frozen OCRTransformer(vocab, 1, (1, 2, 5, 3), 16 heads) of the
    text-focus and stroke-focus losses, from seed 0, its weights those of
    TRAIN.VAL.oracle_checkpoint where one is configured: a checkpoint
    directory in the JAX package's format (JAX's apps read it as their
    oracle, apps/scene_text_telescope/main.py:44-57), through the
    `ocr_transformer` porter."""
    from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer

    oracle = seeded(lambda: OCRTransformer(vocab=vocab, num_in=1,
                                           layers=(1, 2, 5, 3),
                                           num_heads=16), 0, device)
    path = cfg.TRAIN.VAL.get("oracle_checkpoint", "")
    if path:
        oracle.load_state_dict(ckpt_lib.load_model_state(path,
                                                         module=oracle))
    else:
        log.warning("no pretrained oracle checkpoint configured "
                    "(TRAIN.VAL.oracle_checkpoint); using a random-init "
                    "oracle")
    return oracle


def build_recognizer(device) -> torch.nn.Module:
    """The frozen CRNN(32, 1, 37, 256) evaluator on gray input
    (interfaces/base.py:310), from seed 1."""
    from fudanocr_tpu_torch.models.rec.crnn import CRNN

    return seeded(lambda: CRNN(num_classes=37), 1, device).eval()


def resume_path(args, cfg) -> Optional[str]:
    """`--resume`'s checkpoint: the path given, or with 'auto'
    ckpt_dir/best.pt when it exists, else ckpt_dir/best/ (the JAX
    package's format) when it exists; None without the flag."""
    if not args.resume:
        return None
    if args.resume != "auto":
        return args.resume
    for name in ("best.pt", "best"):
        path = os.path.join(cfg.TRAIN.ckpt_dir, name)
        if os.path.exists(path):
            return path
    return None
