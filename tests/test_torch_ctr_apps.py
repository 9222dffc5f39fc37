"""The four CTR entry points of the port on synthetic data on the CPU
(`--device cpu`), at the JAX package's smoke sizes: `apps.sld.train` in
stroke and character mode, `apps.ccr_clip.pretrain` then
`apps.ccr_clip.train` over its checkpoint (its models made small by
monkeypatching, as stage 2's config fixes them, as JAX's does),
`apps.oictr.train`. Each run writes `ckpt_dir/best/`, which loads strictly
into a fresh model; SLD's evaluation of it reproduces the run's accuracy;
a stage-1 directory holding only JAX's state.msgpack raises, naming
ROADMAP A4."""

import functools
import os

import pytest
import torch

from fudanocr_tpu_torch.core.checkpoint import load_model_state
from torch_threads import one_torch_thread  # noqa: F401

SLD_SMALL = ["batch=8", "synthetic_samples=16", "val_frequency=1000000",
             "max_len=8", "encoder_layers=[1,1,1,1]", "d_embed=32",
             "d_model=64", "d_ff=128", "encoder_width_div=8"]


@pytest.mark.parametrize("mode", ["stroke", "character"])
def test_sld_main(tmp_path, mode):
    from fudanocr_tpu_torch.apps.sld import train as app

    ckpt = str(tmp_path / "sld")
    opts = SLD_SMALL + [f"mode={mode}", f"ckpt_dir={ckpt}"]
    res = app.main(["--device", "cpu", "--options", "epoch=1", *opts])
    best = os.path.join(ckpt, "best")
    assert 0.0 <= res["acc"] <= 1.0 and os.path.isdir(best)
    cfg = app.merge_cli_overrides(app.DEFAULT_CONFIG, opts)
    trainer = app.build_trainer(cfg, "cpu")
    assert trainer.model.generator_word.proj.out_features == (
        7 if mode == "stroke" else 38)
    trainer.model.load_state_dict(load_model_state(best))
    assert trainer.evaluate(0) == res


def test_ccr_clip_pretrain_then_stage2(tmp_path, monkeypatch):
    from fudanocr_tpu_torch.apps.ccr_clip import pretrain, train
    from fudanocr_tpu_torch.models.rec import ccr_clip, ocr_transformer
    from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP

    stage1 = str(tmp_path / "clip")
    res = pretrain.main(["--device", "cpu", "--options", "epoch=1",
                         "batch=4", "synthetic_samples=8", "imageH=32",
                         "imageW=32", "transformer_layers=1",
                         f"ckpt_dir={stage1}"])
    assert 0.0 <= res["acc"] <= 1.0
    state = load_model_state(os.path.join(stage1, "best"))
    CCRCLIP(vocab_size=14, transformer_layers=1).load_state_dict(state)

    # stage 2 builds the 12-layer text tower and the full-width decoder
    monkeypatch.setattr(ccr_clip, "CCRCLIP", functools.partial(
        CCRCLIP, transformer_layers=1))
    monkeypatch.setattr(ocr_transformer, "OCRTransformer", functools.partial(
        ocr_transformer.OCRTransformer, d_embed=32, d_model=64, d_ff=128,
        encoder_width_div=8))
    stage2 = str(tmp_path / "ctr")
    opts = ["batch=4", "synthetic_samples=8", "image_size=32", "max_len=6",
            f"radical_model={stage1}/best", f"ckpt_dir={stage2}"]
    res = train.main(["--device", "cpu", "--options", "epoch=1", *opts])
    assert 0.0 <= res["acc"] <= 1.0
    cfg = train.merge_cli_overrides(train.DEFAULT_CONFIG, opts)
    trainer, gallery = train.build_trainer(cfg, "cpu")
    assert gallery.shape == (38, 2048)
    assert torch.equal(gallery[0], torch.zeros(2048))
    assert torch.equal(gallery[-1], torch.ones(2048))
    trainer.model.load_state_dict(load_model_state(
        os.path.join(stage2, "best")))


def test_stage2_refuses_a_jax_checkpoint(tmp_path):
    from fudanocr_tpu_torch.apps.ccr_clip import train

    jax_dir = tmp_path / "jax_best"
    jax_dir.mkdir()
    (jax_dir / "state.msgpack").write_bytes(b"\x80")
    with pytest.raises(NotImplementedError, match="A4"):
        train.main(["--device", "cpu", "--options",
                    f"radical_model={jax_dir}", f"ckpt_dir={tmp_path}"])


def test_oictr_main(tmp_path):
    from fudanocr_tpu_torch.apps.oictr import train as app
    from fudanocr_tpu_torch.models.rec.oictr import OICTR

    ckpt = str(tmp_path / "oictr")
    res = app.main(["--device", "cpu", "--options", "epoch=2", "batch=4",
                    "synthetic_samples=8", "max_len=4", "imageH=32",
                    "imageW=32", "val_frequency=1000000",
                    "encoder_layers=1,1,1", "d_model=64", "d_embed=32",
                    "encoder_width_div=8", f"ckpt_dir={ckpt}"])
    assert 0.0 <= res["acc"] <= 1.0
    OICTR(38, 32, 64, image_size=(32, 32), encoder_layers=(1, 1, 1),
          encoder_width_div=8).load_state_dict(load_model_state(
              os.path.join(ckpt, "best")))


def test_entry_points_default_to_the_card(tmp_path):
    """Without --device the apps ask for CUDA, and a missing card raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from fudanocr_tpu_torch.apps.oictr import train as app

    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--options", f"ckpt_dir={tmp_path}"])
