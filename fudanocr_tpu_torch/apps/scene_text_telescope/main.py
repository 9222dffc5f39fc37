"""Scene Text Telescope entry point (port of
fudanocr_tpu/apps/scene_text_telescope/main.py).

CLI of the reference (scene-text-telescope/main.py:8-40):
  python -m fudanocr_tpu_torch.apps.scene_text_telescope.main \\
      --arch tbsrn --STN --text_focus [--test] [--demo] [--resume auto] \\
      [--config cfg.yaml] [--device cuda]

Trains with the text-focus loss over a frozen OCRTransformer oracle (plain
MSE without --text_focus), evaluates PSNR/SSIM and a frozen CRNN's
accuracy, and keeps the best weights in TRAIN.ckpt_dir/best.pt. A
training run refuses a TRAIN.ckpt_dir that already has contents unless
it resumes, and logs its metrics there (metrics.jsonl). Several
TRAIN.VAL.val_data_dir entries become difficulty buckets named after
their directories (easy/medium/hard). `--test` evaluates, `--demo` writes
TRAIN.VAL.n_vis LR|SR|HR strips to TRAIN.VAL.vis_dir and evaluates.
Returns the final evaluation's dict. Under torchrun
(`torchrun --nproc_per_node N -m fudanocr_tpu_torch.apps.
scene_text_telescope.main ...`) it trains data-parallel on N cards, one
process each, TRAIN.batch_size being the global batch
(`apps/sr_common.distributed_device`, train/sr.py).
"""

from __future__ import annotations

import logging
import os

from fudanocr_tpu_torch.apps import sr_common
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = sr_common.build_argparser(
        "Scene Text Telescope (TBSRN) on PyTorch").parse_args(argv)
    cfg = sr_common.load_app_config(args)
    device = sr_common.distributed_device(args.device)
    training = not (args.test or args.demo)

    model = sr_common.build_sr_model(args, cfg, device)
    train_data = sr_common.build_dataset(cfg.TRAIN.train_data_dir, cfg,
                                         train=True)
    val_dirs = cfg.TRAIN.VAL.val_data_dir
    if len(val_dirs) > 1:
        val_data = {os.path.basename(d.rstrip("/")):
                    sr_common.build_dataset(d, cfg, train=False)
                    for d in val_dirs}
    else:
        val_data = sr_common.build_dataset(val_dirs[0] if val_dirs else [],
                                           cfg, train=False)

    from fudanocr_tpu_torch.losses.sr_losses import LOSS_VOCAB, TextFocusLoss
    if args.text_focus:
        loss_fn = TextFocusLoss(sr_common.build_oracle(cfg, LOSS_VOCAB,
                                                       device))
    else:
        loss_fn = TextFocusLoss(None, text_focus=False)

    # the run dir is checked before the trainer logs into it
    if training:
        from fudanocr_tpu_torch.core.logging import guard_run_dir
        if not guard_run_dir(cfg.TRAIN.ckpt_dir, sources=[__file__],
                             resume=bool(args.resume)):
            return None

    from fudanocr_tpu_torch.train.sr import SRTrainer
    trainer = SRTrainer(
        model, loss_fn, train_data, val_data,
        batch_size=cfg.TRAIN.batch_size, lr=cfg.TRAIN.lr,
        epochs=cfg.TRAIN.epochs, eval_every=cfg.TRAIN.VAL.valInterval,
        ckpt_dir=cfg.TRAIN.ckpt_dir,
        log_dir=cfg.TRAIN.ckpt_dir if training else None,
        num_workers=sr_common.num_workers(cfg),
        recognizer=sr_common.build_recognizer(device),
        converter=CTCLabelConverter(sr_common.ALPHABET),
        seed=cfg.TRAIN.manualSeed)

    path = sr_common.resume_path(args, cfg)
    if path:
        trainer.resume(path)

    if args.demo:
        out = trainer.demo(cfg.TRAIN.VAL.vis_dir, n_vis=cfg.TRAIN.VAL.n_vis)
        print(f"wrote demo strips to {out}")
        res = trainer.evaluate(0)
    elif args.test:
        res = trainer.evaluate(0)
    else:
        trainer.train()
        res = trainer.evaluate(-1)
    print(res)
    return res


if __name__ == "__main__":
    main()
