"""The segmentation slice of the port (fudanocr_tpu_torch/models/seg,
apps/seg/inference.py) against the JAX package on the CPU: a narrow
CascadeMiT (embed_dims 8, one layer per stage, heads (1, 2, 5, 8), sr
(8, 4, 2, 1)) and SegformerHead(2 classes, 32 channels), with the JAX
variables (non-trivial BN statistics and LN scales) carried across by
`load_jax_variables`.

Bars: logits fp32 atol 2e-4 (the module-parity bar, ROADMAP.md); class
maps equal wherever the JAX logits' top-2 margin exceeds 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.apps.seg import inference as jinf
from fudanocr_tpu.data import seg_pipeline as jpp
from fudanocr_tpu.models.seg import CascadeMiT as JaxCascadeMiT
from fudanocr_tpu.models.seg import EncoderDecoder as JaxEncoderDecoder
from fudanocr_tpu.models.seg import SegformerHead as JaxSegformerHead
from fudanocr_tpu.models.seg.encoder_decoder import (
    slide_inference as jax_slide_inference)
from fudanocr_tpu_torch.apps.seg import inference as pinf
from fudanocr_tpu_torch.data import seg_pipeline as ppp
from fudanocr_tpu_torch.models.seg import (CascadeMiT,
                                           DetGuidedEncoderDecoder,
                                           EncoderDecoder, SegformerHead,
                                           slide_inference)
from fudanocr_tpu_torch.models.seg.encoder_decoder import crop_grid
from fudanocr_tpu_torch.utils.weights import load_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4     # the module-parity bar (ROADMAP.md)
MARGIN = 1e-3   # class maps must agree where the top-2 gap exceeds it
NARROW = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
              sr_ratios=(8, 4, 2, 1))
CONFIG = "configs/seg/textformer_b0_textseg.yaml"
# the config's b0 cut to the narrow width, as `--options` would
OVERRIDES = ("model.backbone.embed_dims=8",
             "model.backbone.num_layers=[1, 1, 1, 1]",
             "model.decode_head.channels=32")


def _randomize(variables, rng):
    """Random weights (fan-in scaled), BN statistics away from 0 / 1, LN
    scales away from 1."""
    def leaf(path, a):
        key = path[-1].key
        if key == "var":
            return (rng.random(a.shape) * 0.5 + 0.75).astype(np.float32)
        if key == "scale":
            return (1 + rng.standard_normal(a.shape) * 0.2).astype(
                np.float32)
        if key in ("mean", "bias"):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        return (rng.standard_normal(a.shape) * fan_in ** -0.5).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def pair():
    """(JAX segmentor, its variables, the port segmentor with them)."""
    jm = JaxEncoderDecoder(backbone=JaxCascadeMiT(**NARROW),
                           decode_head=JaxSegformerHead(2, 32))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = _randomize(jax.tree_util.tree_map(np.asarray, v),
                   np.random.default_rng(0))
    m = EncoderDecoder(CascadeMiT(**NARROW),
                       SegformerHead([8, 16, 40, 64], 2, 32))
    return jm, v, load_jax_variables(m, "segmentor", v, **NARROW).eval()


def _assert_maps_agree(got_map, want_logits):
    top = np.sort(want_logits, -1)
    sure = top[..., -1] - top[..., -2] > MARGIN
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got_map[sure],
                                  want_logits.argmax(-1)[sure])


@pytest.mark.parametrize("hw", [(64, 96), (100, 140)])
def test_segmentor_logits_match_jax(pair, hw):
    """64x96 divides by 32; 100x140 checks the strided convs' output sizes
    and the non-integer bilinear upsampling ratios."""
    jm, v, m = pair
    x = np.random.default_rng(hw[0]).standard_normal(
        (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_crop_grid_is_the_jax_grid():
    for h, w, crop, stride in [(96, 160, (64, 64), (48, 48)),
                               (1024, 2048, (1024, 1024), (768, 768)),
                               (50, 700, (64, 64), (48, 48)),
                               (130, 130, (64, 64), (64, 64))]:
        ch, cw, pos = crop_grid(h, w, crop, stride)
        assert (ch, cw) == (min(crop[0], h), min(crop[1], w))
        assert all(0 <= y <= h - ch and 0 <= x <= w - cw for y, x in pos)
    assert crop_grid(1024, 2048, (1024, 1024), (768, 768))[2] == [
        (0, 0), (0, 768), (0, 1024)]


def test_slide_inference_matches_jax(pair):
    """Crop 64, stride 48 over 96x160: a 2 x 3 grid whose last column is
    clamped to the border; batch 2 with max_fwd_images 4 runs 2 crops per
    forward."""
    jm, v, m = pair
    x = np.random.default_rng(5).standard_normal(
        (2, 96, 160, 3)).astype(np.float32)
    fwd = jax.jit(lambda t: jm.apply(v, t))
    want = np.asarray(jax_slide_inference(fwd, jnp.asarray(x), (64, 64),
                                          (48, 48), max_fwd_images=4))
    calls = []

    def apply(t):
        calls.append(t.shape[0])
        return m(t)

    with torch.inference_mode():
        got = slide_inference(apply, torch.from_numpy(x), (64, 64), (48, 48),
                              max_fwd_images=4).numpy()
    assert calls == [4, 4, 4]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def from_config():
    """The JAX and port segmentors built from the b0 TextSeg config (cut
    by OVERRIDES) through each package's `init_segmentor`, the port's with
    the JAX variables."""
    jm, v, cfg = jinf.init_segmentor(CONFIG, overrides=OVERRIDES)
    v = _randomize(jax.tree_util.tree_map(np.asarray, v),
                   np.random.default_rng(1))
    m, pcfg = pinf.init_segmentor(CONFIG, v, device="cpu",
                                  overrides=OVERRIDES)
    assert pcfg.to_dict() == cfg.to_dict()
    return jm, v, m


@pytest.mark.parametrize("crop", [None, (64, 64)])
def test_inference_segmentor_matches_jax(from_config, crop):
    """Whole mode and slide mode (crop 64, stride 48) on a 96x160 uint8
    image: class maps and logits."""
    jm, v, m = from_config
    img = np.random.default_rng(7).integers(0, 256, (96, 160, 3),
                                            dtype=np.uint8)
    stride = (48, 48) if crop else None
    want_map = jinf.inference_segmentor(jm, v, img, crop, stride)
    x = ((img.astype(np.float32) - np.float32([123.675, 116.28, 103.53]))
         / np.float32([58.395, 57.12, 57.375]))[None]
    fwd = jax.jit(lambda t: jm.apply(v, t))
    want = np.asarray(fwd(jnp.asarray(x)) if crop is None else
                      jax_slide_inference(fwd, jnp.asarray(x), crop, stride))
    seg, logits = pinf.inference_segmentor(m, img, crop, stride,
                                           return_logits=True)
    assert seg.shape == (96, 160) and logits.shape == (1, 96, 160, 2)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=ATOL)
    _assert_maps_agree(seg, want[0])
    _assert_maps_agree(np.asarray(want_map), want[0])
    np.testing.assert_array_equal(pinf.show_result(img, want_map),
                                  jinf.show_result(img, want_map))


@pytest.mark.parametrize("seg_pad_val", [0, 255])
def test_seg_transforms_match_jax(seg_pad_val):
    rng = np.random.default_rng(seg_pad_val)
    img = rng.integers(0, 256, (37, 50, 3), dtype=np.uint8)
    gt = rng.integers(0, 2, (37, 50), dtype=np.uint8)

    def run(pp):
        s = {"img": img.copy(), "gt_seg": gt.copy()}
        return pp.Pad((64, 48), seg_pad_val=seg_pad_val)(pp.Normalize()(s))

    got, want = run(ppp), run(jpp)
    assert got["img"].shape == (64, 50, 3) and got["gt_seg"].shape == (64, 50)
    for key in ("img", "gt_seg"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_init_segmentor_seeded_and_det_guided_refused():
    """Seeded initialisation. A det-guided config, refused until the
    det-guided slice was ported, now builds the det-guided segmentor
    (tests/test_torch_det_guided.py holds it against JAX); what is still
    refused is a registered type the port does not have."""
    a, _ = pinf.init_segmentor(CONFIG, device="cpu", overrides=OVERRIDES)
    b, _ = pinf.init_segmentor(CONFIG, device="cpu", overrides=OVERRIDES)
    c, _ = pinf.init_segmentor(CONFIG, device="cpu", overrides=OVERRIDES,
                               seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert not a.training
    det, _ = pinf.init_segmentor("configs/seg/textformer_b0_textseg_det.yaml",
                                 device="cpu", overrides=OVERRIDES)
    assert isinstance(det, DetGuidedEncoderDecoder)
    with pytest.raises(NotImplementedError, match="CascadeMiT"):
        pinf.init_segmentor(CONFIG, device="cpu", overrides=OVERRIDES + (
            "model.backbone.type=MixVisionTransformer",))
