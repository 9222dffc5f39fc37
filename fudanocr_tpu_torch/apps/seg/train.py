"""Scene text segmentation trainer (port of fudanocr_tpu/apps/seg/train.py;
text-focused-Transformers/tools/train.py).

    python -m fudanocr_tpu_torch.apps.seg.train \\
        configs/seg/textformer_b0_textseg.yaml [--options k.subk=v ...] \\
        [--auto-resume] [--test-only] [--device cuda]

The config (with `_base_` inheritance) gives CascadeMiT + SegFormer head
(det-guided for `*_det` files), the Adam / poly recipe and periodic mIoU
evaluation: slide inference at test.crop / test.stride over a dataset
directory, the whole image on the synthetic set, which stands in when no
`data.img_dir` is configured. Checkpoints go to `ckpt_dir`
(train/seg.py); `--auto-resume` continues from the latest iter_
checkpoint there. A training run also logs its metrics and prediction
tables there (`core/logging.MetricsLogger`). `--test-only` evaluates and
writes nothing: it leaves a trained `best/` as it is (JAX's app writes
`best/` from a test-only evaluation). The model is built on the CPU from
seed 0 and moved to `--device` (default the card; a missing card raises).
The config's host knobs go through `core/runtime_env.setup_multi_processes`
first, as in JAX's app. Under torchrun (`torchrun --nproc_per_node N -m
fudanocr_tpu_torch.apps.seg.train <config> ...`) it trains data-parallel on
N cards, data.batch_size being the global batch (train/seg.py).
Returns the final evaluation's dict.
"""

from __future__ import annotations

import argparse
import logging

from fudanocr_tpu_torch.apps.sr_common import distributed_device, seeded
from fudanocr_tpu_torch.core.config import load_config, merge_cli_overrides

log = logging.getLogger("fudanocr_tpu_torch.seg_app")


def build_data(cfg, train: bool):
    """The train or test dataset of the config: SegDataset over the
    configured directories with the reference pipelines, or the synthetic
    set (normalised only) when `data.dataset` is "synthetic" or no
    `data.img_dir` is set."""
    from fudanocr_tpu_torch.data import seg_pipeline as pp
    from fudanocr_tpu_torch.data.seg_dataset import (SegDataset,
                                                     SyntheticTextSeg)

    d = cfg.data
    crop = tuple(d.crop_size)
    train_pipeline = [
        pp.LoadImageFromFile(),
        pp.Resize((crop[1] * 2, crop[0] * 2), (0.5, 2.0),
                  keep_ratio=d.get("keep_ratio", True)),
        pp.RandomCrop(crop),
        pp.RandomFlip(0.5),
        pp.PhotoMetricDistortion(),
        pp.Normalize(),
        # train padding counts as background (seg_pad_val 0), as the
        # reference configs set it
        pp.Pad(crop, seg_pad_val=d.get("seg_pad_val", 0)),
    ]
    # evaluation padding stays ignored (255)
    test_pipeline = [pp.LoadImageFromFile(), pp.Normalize(),
                     pp.Pad(crop, seg_pad_val=255)]
    pipeline = train_pipeline if train else test_pipeline

    if d.dataset == "synthetic" or not d.img_dir:
        n = d.synthetic_samples
        return SyntheticTextSeg(n if train else max(n // 4, 4),
                                tuple(d.synthetic_size), [pp.Normalize()],
                                seed=0 if train else 1,
                                with_det=bool(d.get("det_dir", "")
                                              or cfg.model.get("det_guided")))
    pipeline.insert(1, pp.LoadAnnotations(pp.REMAPS[d.dataset]))
    img_dir = d.img_dir if train else (d.val_img_dir or d.img_dir)
    ann_dir = d.ann_dir if train else (d.val_ann_dir or d.ann_dir)
    # det masks exist for the train split only, and evaluation never reads
    # them
    det_dir = (d.get("det_dir") or None) if train else None
    return SegDataset(img_dir, ann_dir, pipeline, det_dir=det_dir)


def build_model(cfg, device="cuda"):
    """The configured segmentor (apps/seg/inference.build_model), built on
    the CPU from seed 0 (the JAX trainer's init key), on `device` (a
    missing card raises)."""
    from fudanocr_tpu_torch.apps.seg.inference import build_model as build

    return seeded(lambda: build(cfg), 0, device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description="scene text segmentation")
    p.add_argument("config")
    p.add_argument("--test-only", action="store_true")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the latest periodic checkpoint in "
                        "ckpt_dir")
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)
    cfg = merge_cli_overrides(load_config(args.config), args.options)

    # host-threading knobs before anything is built (tools/train.py), as
    # JAX's app does
    from fudanocr_tpu_torch.core.runtime_env import setup_multi_processes
    from fudanocr_tpu_torch.utils.collect_env import collect_env

    setup_multi_processes(cfg)
    device = distributed_device(args.device)
    for k, v in collect_env().items():
        log.info("%s: %s", k, v)

    from fudanocr_tpu_torch.train.seg import SegTrainer

    model = build_model(cfg, device)
    train_data = build_data(cfg, True)
    eval_data = build_data(cfg, False)

    use_slide = (cfg.test.mode == "slide"
                 and cfg.data.dataset != "synthetic" and cfg.data.img_dir)
    tc = cfg.get("train_cfg", {})
    trainer = SegTrainer(
        model, train_data, eval_data,
        num_classes=cfg.model.decode_head.num_classes,
        batch_size=cfg.data.batch_size, lr=cfg.optimizer.lr,
        total_iters=cfg.schedule.total_iters,
        eval_every=cfg.schedule.eval_every,
        loss_weights=cfg.loss.to_dict(),
        crop=tuple(cfg.test.crop) if use_slide else None,
        stride=tuple(cfg.test.stride) if use_slide else None,
        ckpt_dir=cfg.ckpt_dir,
        det_loss_ratio=tc.get("det_loss_ratio", 0.1),
        gt_guided_masks=tc.get("gt_guided_masks", False),
        log_dir=None if args.test_only else cfg.ckpt_dir,
        auto_resume=args.auto_resume)

    if args.test_only:
        res = trainer.evaluate(0, save_best=False)
    else:
        trainer.train()
        res = trainer.evaluate(-1)
    print(res)
    return res


if __name__ == "__main__":
    main()
