"""Text Gestalt entry point, stroke-aware TSRN (port of
fudanocr_tpu/apps/text_gestalt/main.py).

CLI of text-gestalt/main.py:
  python -m fudanocr_tpu_torch.apps.text_gestalt.main \\
      --arch tsrn --STN --text_focus [--stroke_lambda 50] \\
      [--decomposition english_decomposition.txt] [--test] [--device cuda]

--text_focus trains with the stroke-focus loss (MSE + stroke_lambda x the
L1 between the frozen 10-class stroke oracle's attention maps on HR and
SR) over `StrokeSRTrainer`, whose labels go through the stroke codec (its
built-in table without --decomposition). `--test` and `--demo` evaluate,
as in the JAX app. `--resume` loads a best.pt ('auto':
TRAIN.ckpt_dir/best.pt) before anything else; the JAX app takes the flag
for its overwrite guard only. A training run logs its metrics to
TRAIN.ckpt_dir (metrics.jsonl). Returns the final evaluation's dict.
Under torchrun it trains data-parallel, one process per card, as
`scene_text_telescope.main` does.
"""

from __future__ import annotations

import logging

from fudanocr_tpu_torch.apps import sr_common
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = sr_common.build_argparser(
        "Text Gestalt (stroke-aware TSRN) on PyTorch")
    parser.add_argument("--stroke_lambda", type=float, default=50.0)
    parser.add_argument("--decomposition", type=str, default="",
                        help="english_decomposition.txt path")
    args = parser.parse_args(argv)
    cfg = sr_common.load_app_config(args)
    device = sr_common.distributed_device(args.device)
    training = not (args.test or args.demo)

    model = sr_common.build_sr_model(args, cfg, device)
    train_data = sr_common.build_dataset(cfg.TRAIN.train_data_dir, cfg, True)
    val_dirs = cfg.TRAIN.VAL.val_data_dir
    val_data = sr_common.build_dataset(val_dirs[0] if val_dirs else [], cfg,
                                       False)

    from fudanocr_tpu_torch.data.codecs import english_stroke_codec
    codec = english_stroke_codec(args.decomposition or None)

    if args.text_focus:
        from fudanocr_tpu_torch.losses.stroke_focus import StrokeFocusLoss
        loss_fn = StrokeFocusLoss(
            sr_common.build_oracle(cfg, codec.num_classes, device),
            stroke_lambda=args.stroke_lambda)
    else:
        from fudanocr_tpu_torch.losses.sr_losses import TextFocusLoss
        loss_fn = TextFocusLoss(None, text_focus=False)

    # the run dir is checked before the trainer logs into it
    if training:
        from fudanocr_tpu_torch.core.logging import guard_run_dir
        if not guard_run_dir(cfg.TRAIN.ckpt_dir, sources=[__file__],
                             resume=bool(args.resume)):
            return None

    from fudanocr_tpu_torch.train.sr import StrokeSRTrainer
    trainer = StrokeSRTrainer(
        model, loss_fn, train_data, val_data,
        batch_size=cfg.TRAIN.batch_size, lr=cfg.TRAIN.lr,
        epochs=cfg.TRAIN.epochs, eval_every=cfg.TRAIN.VAL.valInterval,
        ckpt_dir=cfg.TRAIN.ckpt_dir,
        log_dir=cfg.TRAIN.ckpt_dir if training else None,
        num_workers=sr_common.num_workers(cfg),
        recognizer=sr_common.build_recognizer(device),
        converter=CTCLabelConverter(sr_common.ALPHABET),
        seed=cfg.TRAIN.manualSeed, codec=codec)

    path = sr_common.resume_path(args, cfg)
    if path:
        trainer.resume(path)

    if not training:
        res = trainer.evaluate(0)
    else:
        trainer.train()
        res = trainer.evaluate(-1)
    print(res)
    return res


if __name__ == "__main__":
    main()
