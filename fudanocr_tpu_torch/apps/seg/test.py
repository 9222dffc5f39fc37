"""Segmentation evaluation entry (port of fudanocr_tpu/apps/seg/test.py;
text-focused-Transformers/tools/test.py).

    python -m fudanocr_tpu_torch.apps.seg.test \\
        configs/seg/textformer_b0_textseg.yaml \\
        [--checkpoint ckpt_dir/best] [--tta] [--options k.subk=v ...] \\
        [--device cuda]

Builds the configured segmentor (apps/seg/train.build_model: seed 0, then
`--device`, default the card; a missing card raises), loads the weights of
a `SegTrainer` checkpoint directory (`core/checkpoint.load_model_state`:
its state.pt, or the JAX package's state.msgpack where it has no
state.pt) and evaluates the config's test
set. Without `--tta`, `SegTrainer.evaluate(save_best=False)` on whole
images, as the JAX app's trainer, built without a crop, does. With
`--tta`, `tta_inference` at scales (0.75, 1.0, 1.25) with horizontal
flips, each variant through slide inference at test.crop / test.stride
when test.mode is slide (MultiScaleFlipAug wrapping the slide test, as in
the reference), the class map the argmax of the averaged probabilities.
Prints and returns aAcc / mIoU / mDice / mFscore.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from fudanocr_tpu_torch.apps.sr_common import resolve_device
from fudanocr_tpu_torch.core.config import load_config, merge_cli_overrides

TTA_SCALES = (0.75, 1.0, 1.25)


def tta_metrics(model, eval_data, cfg) -> dict:
    """aAcc / mIoU / mDice / mFscore of `model` over `eval_data` with test-
    time augmentation (see the module docstring)."""
    from fudanocr_tpu_torch.eval.seg_metrics import (intersect_and_union,
                                                     total_metrics)
    from fudanocr_tpu_torch.models.seg import slide_inference, tta_inference

    dev = next(model.parameters()).device
    num_classes = cfg.model.decode_head.num_classes

    def fwd(x):
        out = model(x)
        return out[0] if isinstance(out, tuple) else out

    scale_fwd = fwd
    if cfg.test.mode == "slide":
        crop, stride = tuple(cfg.test.crop), tuple(cfg.test.stride)
        scale_fwd = lambda x: slide_inference(fwd, x, crop, stride)
    hist = np.zeros((4, num_classes), np.float64)
    with torch.inference_mode():
        for batch in eval_data.batches(cfg.data.batch_size):
            img = torch.from_numpy(np.asarray(batch["img"])).to(dev).float()
            pred = tta_inference(scale_fwd, img, scales=TTA_SCALES).argmax(-1)
            gt = torch.from_numpy(np.asarray(batch["gt_seg"])).to(dev)
            if "valid" in batch:
                valid = torch.from_numpy(np.asarray(batch["valid"])).to(dev)
                gt = torch.where(valid[:, None, None] > 0, gt, 255)
            counts = intersect_and_union(pred, gt, num_classes)
            hist += torch.stack(counts).cpu().numpy()
    res = total_metrics(*hist)
    return {k: res[k] for k in ("aAcc", "mIoU", "mDice", "mFscore")}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="scene text segmentation eval")
    p.add_argument("config")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--tta", action="store_true",
                   help="multi-scale + flip test-time augmentation")
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)
    cfg = merge_cli_overrides(load_config(args.config), args.options)
    device = resolve_device(args.device)

    from fudanocr_tpu_torch.apps.seg.train import build_data, build_model
    from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
    from fudanocr_tpu_torch.train.seg import SegTrainer

    model = build_model(cfg, device)
    if args.checkpoint:
        model.load_state_dict(ckpt_lib.load_model_state(
            args.checkpoint, device, module=model))
    eval_data = build_data(cfg, train=False)
    if args.tta:
        res = tta_metrics(model, eval_data, cfg)
    else:
        trainer = SegTrainer(model, eval_data, eval_data,
                             num_classes=cfg.model.decode_head.num_classes,
                             batch_size=cfg.data.batch_size, total_iters=1,
                             eval_every=10 ** 9)
        res = trainer.evaluate(0, save_best=False)
    print(res)
    return res


if __name__ == "__main__":
    main()
