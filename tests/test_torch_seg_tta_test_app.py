"""Test-time augmentation and the seg evaluation app of the port
(`ops/resize.resize_bilinear` / `resize_nearest`, `models/seg/
encoder_decoder.tta_inference`, `apps/seg/test.py`, `apps/seg/inference.
init_segmentor(checkpoint=)`) against the JAX package on the CPU.

Bars, with what they measured (CPU, torch 2.13, jax 0.9):

* `resize_bilinear` against `jax.image.resize(..., "bilinear")` (which
  antialiases when it shrinks) at the TTA ratios 0.75 and 1.25 and at odd
  sizes: float32 (`F.interpolate(antialias=<shrinking>)`) atol 1e-5
  (measured at most 4.9e-6, at 32² -> 40²); bfloat16 bit for bit (JAX's
  bf16 weight matrices, one axis after the other). `resize_nearest`
  against JAX's "nearest", bit for bit.
* `tta_inference` against JAX's on a position-dependent pseudo-model
  (so the flip matters), scales (0.75, 1.0, 1.25) with flips: the
  averaged probabilities at fp32 atol 1e-5; on a narrow segmentor (the
  module-parity bar, logits atol 2e-4) at atol 1e-4 (measured 1.8e-7).
* `apps.seg.test` with and without `--tta` on a seeded directory dataset
  (textseg coding, JPEG photos written with PIL) and the narrow b0 cut of
  the TextSeg config, from a checkpoint `SegTrainer` wrote, against JAX's
  app on the same weights (a JAX checkpoint of them): aAcc / mIoU / mDice
  / mFscore within 1e-3 (one pixel of the 14,336 moves aAcc by 7e-5;
  measured: 6.9e-5 without TTA, one pixel; 0 with it). A JAX-format
  checkpoint directory of those weights loads; one of another shape is
  refused.
* The bf16 resize's cached weight matrices made under inference mode (an
  evaluation) serve a later training forward's backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from fudanocr_tpu.apps.seg import test as japp
from fudanocr_tpu.core import checkpoint as jckpt
from fudanocr_tpu.models.seg.encoder_decoder import tta_inference as jtta
from fudanocr_tpu_torch.apps.seg import inference as pinf
from fudanocr_tpu_torch.apps.seg import test as papp
from fudanocr_tpu_torch.apps.seg.train import build_data, build_model
from fudanocr_tpu_torch.core.config import load_config, merge_cli_overrides
from fudanocr_tpu_torch.models.seg import tta_inference
from fudanocr_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from fudanocr_tpu_torch.train.seg import SegTrainer
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)
from test_torch_seg_model import _randomize
from torch_threads import one_torch_thread  # noqa: F401

CONFIG = "configs/seg/textformer_b0_textseg.yaml"
NARROW = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
              sr_ratios=(8, 4, 2, 1))
TTA_SCALES = (0.75, 1.0, 1.25)
# (source, destination) sizes: the TTA ratios, odd sizes, 2x / 4x / 8x
RESIZES = [((64, 96), (48, 72)), ((100, 140), (75, 105)),
           ((64, 96), (80, 120)), ((33, 47), (24, 35)), ((7, 9), (13, 18)),
           ((32, 32), (40, 40)), ((25, 35), (100, 140)), ((16, 16), (32, 32)),
           ((8, 16), (32, 64)), ((16, 8), (128, 64))]


def _jax_resize(x: np.ndarray, hw, dt, method="bilinear") -> np.ndarray:
    out = jax.image.resize(jnp.asarray(x, dt), (x.shape[0], *hw, x.shape[3]),
                           method)
    return np.asarray(out.astype(jnp.float32))


def _port_resize(x: np.ndarray, hw, dt, fn=resize_bilinear) -> np.ndarray:
    t = torch.from_numpy(x).to(dt).permute(0, 3, 1, 2)
    return fn(t, hw).float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("src, dst", RESIZES)
def test_resize_bilinear_is_jax_resize(src, dst):
    x = np.random.default_rng(src[0] * dst[1]).standard_normal(
        (2, *src, 3)).astype(np.float32)
    want = _jax_resize(x, dst, jnp.float32)
    np.testing.assert_allclose(_port_resize(x, dst, torch.float32), want,
                               rtol=0, atol=1e-5)
    # the same function written as the library call it is in float32
    shrink = dst[0] < src[0] or dst[1] < src[1]
    lib = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst,
                        mode="bilinear", align_corners=False,
                        antialias=shrink).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(lib, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_port_resize(x, dst, torch.bfloat16),
                                  _jax_resize(x, dst, jnp.bfloat16))


@pytest.mark.parametrize("src, dst", [((16, 16), (32, 32)), ((7, 9), (13, 18)),
                                      ((33, 47), (24, 35))])
def test_resize_nearest_is_jax_resize(src, dst):
    x = np.random.default_rng(1).standard_normal((1, *src, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(
        _port_resize(x, dst, torch.float32, resize_nearest),
        _jax_resize(x, dst, jnp.float32, "nearest"))


def test_bf16_resize_weights_from_inference_serve_a_backward():
    from fudanocr_tpu_torch.ops import resize

    resize._weights.cache_clear()
    x = torch.randn(1, 2, 6, 10).bfloat16()
    with torch.inference_mode():       # an evaluation fills the cache
        want = resize_bilinear(x, (9, 15))
    y = x.clone().requires_grad_()
    got = resize_bilinear(y, (9, 15))
    got.float().sum().backward()
    assert torch.equal(got.detach(), want) and y.grad.shape == y.shape


def _pseudo_logits(x, lib):
    """Two logits per pixel, the second with a ramp across the width, so
    that a flip that is not undone changes the result."""
    w = x.shape[2]
    ramp = lib.linspace(-1.0, 1.0, w)[None, None, :]
    a = x[..., 0] * 4 + x[..., 1]
    b = (x[..., 1] - x[..., 2]) * 3 + 2 * ramp
    return lib.stack([a, b], -1)


@pytest.mark.parametrize("hw", [(37, 53), (64, 96)])
def test_tta_probabilities_match_jax(hw):
    x = np.random.default_rng(hw[0]).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jtta(lambda t: _pseudo_logits(t, jnp), jnp.asarray(x),
                           scales=TTA_SCALES, flip=True))
    got = tta_inference(lambda t: _pseudo_logits(t, torch),
                        torch.from_numpy(x), scales=TTA_SCALES, flip=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    no_flip = tta_inference(lambda t: _pseudo_logits(t, torch),
                            torch.from_numpy(x), scales=TTA_SCALES,
                            flip=False)
    assert not torch.allclose(no_flip, got, atol=1e-3)


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    """A seeded textseg-coded directory: 3 JPEG q90 photos (PIL) and PNG
    annotations (100 text, 200 background, 255 ignored)."""
    root = tmp_path_factory.mktemp("seg_test_app")
    rng = np.random.default_rng(3)
    for d in ("img", "ann"):
        (root / d).mkdir()
    for i, (h, w) in enumerate([(64, 96), (72, 64), (64, 64)]):
        base = rng.integers(40, 220, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        ann = np.full((h, w), 200, np.uint8)
        for _ in range(3):
            y, x = rng.integers(0, h - 12), rng.integers(0, w - 20)
            ann[y:y + 10, x:x + 18] = 100
            img[y:y + 10, x:x + 18] = rng.integers(0, 40, 3)
        ann[rng.random((h, w)) < 0.02] = 255
        Image.fromarray(img.astype(np.uint8)).save(root / "img" / f"p{i}.jpg",
                                                   quality=90)
        Image.fromarray(ann).save(root / "ann" / f"p{i}.png")
    return root


def _options(root):
    return ["model.backbone.embed_dims=8",
            "model.backbone.num_layers=[1, 1, 1, 1]",
            "model.decode_head.channels=32", "data.crop_size=[64, 64]",
            "data.batch_size=1", "test.crop=[64, 64]", "test.stride=[48, 48]",
            f"data.img_dir={root}/img", f"data.ann_dir={root}/ann",
            f"data.val_img_dir={root}/img", f"data.val_ann_dir={root}/ann"]


@pytest.fixture(scope="module")
def checkpoints(photos, tmp_path_factory):
    """(the port's checkpoint written by SegTrainer, a JAX checkpoint of the
    same weights, the model): the app's model with random weights and BN
    and LN statistics (`_randomize` of tests/test_torch_seg_model.py)
    predicting both classes."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = merge_cli_overrides(load_config(CONFIG), _options(photos))
    model = build_model(cfg, "cpu")
    load_jax_variables(model, "segmentor", _randomize(
        to_jax_variables(model, "segmentor", **NARROW),
        np.random.default_rng(4)), **NARROW)
    data = build_data(cfg, train=False)
    # both classes predicted: the classifier's bias centres the first
    # photo's median logit margin
    first = torch.from_numpy(next(data.batches(1))["img"])
    with torch.no_grad():
        margin = model(first).diff(dim=-1).median()
        model.decode_head.conv_seg.bias[1] -= margin
        share = model(first).argmax(-1).float().mean().item()
    assert 0.3 < share < 0.7, share
    trainer = SegTrainer(model, data, data, batch_size=1, total_iters=1,
                         eval_every=10 ** 9, ckpt_dir=str(root / "port"))
    trainer.evaluate(0)                       # writes best/
    v = to_jax_variables(model, "segmentor", **NARROW)
    jckpt.save(str(root / "jax"), v, meta={"step": 0})
    return str(root / "port" / "best"), str(root / "jax"), model


@pytest.mark.parametrize("tta", [False, True])
def test_seg_test_app_metrics_match_jax(photos, checkpoints, tta):
    port_ckpt, jax_ckpt, _ = checkpoints
    opts = ["--options", *_options(photos)] + (["--tta"] if tta else [])
    want = japp.main([CONFIG, "--checkpoint", jax_ckpt, *opts])
    got = papp.main([CONFIG, "--checkpoint", port_ckpt, "--device", "cpu",
                     *opts])
    assert set(got) == set(want) == {"aAcc", "mIoU", "mDice", "mFscore"}
    diffs = {k: abs(got[k] - float(want[k])) for k in want}
    print(f"tta={tta}: port {got}, JAX {want}, differences {diffs}")
    assert max(diffs.values()) <= 1e-3, diffs


def test_checkpoint_loading_and_jax_format_refused(photos, checkpoints):
    port_ckpt, jax_ckpt, model = checkpoints
    overrides = _options(photos)
    loaded, _ = pinf.init_segmentor(CONFIG, device="cpu", overrides=overrides,
                                    seed=5, checkpoint=port_ckpt)
    want = model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in loaded.state_dict().items())
    # JAX's checkpoint of the same weights loads; one of another shape is
    # refused
    loaded, _ = pinf.init_segmentor(CONFIG, device="cpu", overrides=overrides,
                                    seed=5, checkpoint=jax_ckpt)
    assert all(torch.equal(v, want[k]) for k, v in loaded.state_dict().items())
    deeper = [o for o in overrides if "num_layers" not in o]   # (2, 2, 2, 2)
    with pytest.raises(ValueError, match="missing"):
        pinf.init_segmentor(CONFIG, device="cpu", checkpoint=jax_ckpt,
                            overrides=deeper)
    with pytest.raises(ValueError, match="missing"):
        papp.main([CONFIG, "--checkpoint", jax_ckpt, "--device", "cpu",
                   "--options", *deeper])


def test_tta_over_slide_of_a_segmentor_matches_jax(photos, checkpoints):
    """The app's TTA composition on one padded photo: slide at each scale
    and flip, the narrow segmentor on both sides."""
    from fudanocr_tpu.apps.seg.train import build_model as jbuild
    from fudanocr_tpu.core.config import load_config as jload
    from fudanocr_tpu.core.config import merge_cli_overrides as jmerge
    from fudanocr_tpu.models.seg.encoder_decoder import (
        slide_inference as jslide)
    from fudanocr_tpu_torch.models.seg import slide_inference

    _, jax_ckpt, model = checkpoints
    cfg = jmerge(jload(CONFIG), _options(photos))
    jm = jbuild(cfg)
    v = to_jax_variables(model, "segmentor", **NARROW)
    x = np.random.default_rng(6).standard_normal((1, 72, 96, 3)).astype(
        np.float32)
    fwd = jax.jit(lambda t: jm.apply(v, t))
    want = np.asarray(jtta(lambda t: jslide(fwd, t, (64, 64), (48, 48)),
                           jnp.asarray(x), scales=TTA_SCALES))
    with torch.inference_mode():
        got = tta_inference(
            lambda t: slide_inference(model, t, (64, 64), (48, 48)),
            torch.from_numpy(x), scales=TTA_SCALES).numpy()
    err = float(np.abs(got - want).max())
    print(f"TTA over slide, narrow segmentor: max abs err {err:.3e}")
    assert err <= 1e-4
