"""CCR-CLIP stage 2: CTR training against the frozen radical gallery (port
of fudanocr_tpu/apps/ccr_clip/train.py).

image-ids-CTR/train.py: the shared OCRTransformer (the wide "image_ids"
encoder) emits a 2048-d embedding per decoding step (`out_dim=2048`); the
gallery is [zeros, encode_text(each char's IDS)..., ones] from the frozen
stage-1 model at context 30; loss = CE(normalised pred @ gallery^T, gt) -
0.001 * MSE(pred, gallery[gt]) (a repulsion term, train.py:74-80);
Adadelta lr 1.0, decay 1e-4; decoding matches each step's embedding
against the gallery (`greedy_decode_gallery`).

    python -m fudanocr_tpu_torch.apps.ccr_clip.train \\
        --options radical_model=<stage-1 ckpt_dir>/best [k=v ...] \\
        [--device cuda]

`radical_model` is a stage-1 checkpoint directory at the default 12 text
layers: the port's `apps.ccr_clip.pretrain` writes state.pt and
state.msgpack, the JAX package's state.msgpack alone, which is read
through the `ccr_clip` porter. Without it the gallery comes from a random
text tower (seed 0), as in JAX. Under torchrun it trains data-parallel, as
`apps.sld.train` does; stage 1 (`pretrain`) stays on one process, as in
JAX.
"""

from __future__ import annotations

import argparse
import logging

import torch

from fudanocr_tpu_torch.core.config import Config, merge_cli_overrides

log = logging.getLogger("fudanocr_tpu_torch.ccr_clip2")

DEFAULT_CONFIG = Config({
    "epoch": 1,
    "train_dataset": "",
    "test_dataset": "",
    "batch": 32,
    "image_size": 32,
    "alpha_path": "",            # charset file (one char stream)
    "alphabet_path": "",         # radical alphabet (stage 1)
    "decompose_path": "",        # radical decomposition (stage 1)
    "radical_model": "",         # stage-1 checkpoint dir
    "lr": 1.0,
    "max_len": 48,
    "val_frequency": 1000,
    "ckpt_dir": "./ckpt/ccr_clip_ctr",
    "synthetic_samples": 64,
    "test_only": False,
})

GALLERY_CONTEXT = 30   # the stage-1 text tower's context (train.py:40-61)


@torch.no_grad()
def build_gallery(cfg, charset, codec, device) -> torch.Tensor:
    """Frozen text features [zeros, chars..., ones] (train.py:40-61), fp32
    (len(charset) + 2, 2048) on `device`."""
    from fudanocr_tpu_torch.apps.sr_common import seeded
    from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP

    clip = seeded(lambda: CCRCLIP(vocab_size=codec.num_classes,
                                  context_length=GALLERY_CONTEXT), 0, device)
    if cfg.radical_model:
        from fudanocr_tpu_torch.core.checkpoint import load_model_state
        clip.load_state_dict(load_model_state(cfg.radical_model,
                                              map_location=device,
                                              module=clip))
    else:
        log.warning("no stage-1 checkpoint (radical_model); using a random "
                    "CLIP text tower for the gallery")
    feats = [torch.zeros(1, clip.text_projection.shape[1], device=device)]
    for s in range(0, len(charset), 100):
        _, gt, _ = codec.encode(charset[s:s + 100], GALLERY_CONTEXT)
        feats.append(clip.encode_text(torch.from_numpy(gt).to(device)
                                      .long()).float())
    feats.append(torch.ones_like(feats[0]))
    return torch.cat(feats)


def gallery_loss(gallery: torch.Tensor):
    """`loss(out, batch)`: the masked CE of the cosine logits of each
    step's normalised fp32 embedding against the gallery, minus 0.001 x the
    masked MSE between the embedding and its target's gallery row (in a
    data-parallel step, this rank's share: its sums over the global
    count)."""
    from fudanocr_tpu_torch.core.mesh import all_reduce_sum
    from fudanocr_tpu_torch.train.ctr import length_mask

    def loss(out, batch):
        pred = out["pred"].float()
        pred = pred / pred.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        logits = torch.einsum("bld,vd->blv", pred, gallery)
        gt = batch["text_gt"].long()
        mask = length_mask(batch["lengths"], gt.shape[1])
        nll = -logits.log_softmax(-1).gather(-1, gt[..., None])[..., 0]
        n = all_reduce_sum(mask.sum())
        loss_rec = (nll * mask).sum() / n.clamp_min(1.0)
        reg = gallery[gt]
        mse = (((pred - reg) ** 2) * mask[..., None]).sum() / (
            n * reg.shape[-1]).clamp_min(1.0)
        return loss_rec - 0.001 * mse

    return loss


def build_trainer(cfg, device, kernels: bool = True):
    """(CTRTrainer with the gallery loss and decode, gallery)."""
    from fudanocr_tpu_torch.apps.sr_common import seeded
    from fudanocr_tpu_torch.data.codecs import SequenceCodec, radical_codec
    from fudanocr_tpu_torch.data.rec_dataset import (RecLMDBDataset,
                                                     SyntheticCharDataset)
    from fudanocr_tpu_torch.models.rec.ocr_transformer import (
        OCRTransformer, greedy_decode_gallery)
    from fudanocr_tpu_torch.train.ctr import CTRTrainer

    rcodec = radical_codec(cfg.alphabet_path or None,
                           cfg.decompose_path or None)
    if cfg.alpha_path:
        with open(cfg.alpha_path, encoding="utf-8") as f:
            charset = list(f.read())
    else:
        charset = sorted(rcodec.decomposition)
    # the character codec over the gallery's alphabet: '<' + chars + '$'
    codec = SequenceCodec(["<"] + charset + ["$"], None, terminator="$")
    gallery = build_gallery(cfg, charset, rcodec, device)

    size = (cfg.image_size, cfg.image_size)
    if cfg.train_dataset:
        train_data = RecLMDBDataset(cfg.train_dataset.split(","), size)
        test_data = RecLMDBDataset(cfg.test_dataset.split(","), size)
    else:
        cs = "".join(charset)
        train_data = SyntheticCharDataset(cs, cfg.synthetic_samples, size)
        test_data = SyntheticCharDataset(cs, max(cfg.synthetic_samples // 4,
                                                 8), size, seed=1)

    # image-ids-CTR's wide 3-stage encoder with pools before every stage
    # (image-ids-CTR/model/transformer.py:80-152)
    model = seeded(lambda: OCRTransformer(
        vocab=codec.num_classes, out_dim=gallery.shape[1], num_in=3,
        num_heads=4, encoder_preset="image_ids", kernels=kernels), 0, device)
    trainer = CTRTrainer(
        model, codec, train_data, test_data, batch_size=cfg.batch,
        lr=cfg.lr, weight_decay=1e-4, epochs=cfg.epoch,
        eval_every=cfg.val_frequency, max_len=cfg.max_len,
        ckpt_dir=cfg.ckpt_dir, loss_fn=gallery_loss(gallery),
        decode_ids=lambda images: greedy_decode_gallery(
            model, images, gallery, cfg.max_len))
    return trainer, gallery


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="CCR-CLIP stage-2 CTR")
    p.add_argument("--options", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)
    cfg = merge_cli_overrides(DEFAULT_CONFIG, args.options)
    from fudanocr_tpu_torch.apps.sr_common import distributed_device
    trainer, _ = build_trainer(cfg, distributed_device(args.device))
    if cfg.test_only:
        res = trainer.evaluate(0)
    else:
        trainer.train()
        res = trainer.evaluate(-1)
    print(res)
    return res


if __name__ == "__main__":
    main()
