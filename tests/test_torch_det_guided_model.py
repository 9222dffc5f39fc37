"""The det-guided segmentor of the port against the JAX package on the CPU:
a narrow DetGuidedEncoderDecoder with the JAX variables carried across by
the porter, with and without `det_gt`, and `init_segmentor` ->
`inference_segmentor` on a det config (bars and shared constants in
tests/test_torch_det_guided.py, whose docstring says what is held)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.apps.seg import inference as jinf
from fudanocr_tpu.models.seg import CascadeMiTDetGuided as JaxDetGuided
from fudanocr_tpu.models.seg import DetGuidedEncoderDecoder as JaxDetSeg
from fudanocr_tpu.models.seg import SegformerHead as JaxSegformerHead
from fudanocr_tpu_torch.apps.seg import inference as pinf
from fudanocr_tpu_torch.models.seg import det_guided as pdg
from fudanocr_tpu_torch.models.seg import (CascadeMiTDetGuided,
                                           DetGuidedEncoderDecoder,
                                           SegformerHead)
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)
from test_torch_det_guided import ATOL, CONFIG, MARGIN, NARROW, OVERRIDES
from torch_threads import one_torch_thread  # noqa: F401


def _randomize(variables, rng):
    """Random weights (fan-in scaled), BN statistics away from 0 / 1, LN
    scales away from 1; the det classifier scaled up so that every det
    logit margin clears MARGIN."""
    def leaf(path, a):
        names = [getattr(p, "key", "") for p in path]
        key = names[-1]
        if key == "var":
            return (rng.random(a.shape) * 0.5 + 0.75).astype(np.float32)
        if key == "scale":
            return (1 + rng.standard_normal(a.shape) * 0.2).astype(
                np.float32)
        if key in ("mean", "bias"):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        gain = 30.0 if "det_cls" in names else 1.0
        return (rng.standard_normal(a.shape) * gain * fan_in ** -0.5).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def pair():
    """(JAX det segmentor (device labelling), its variables, the port's
    with them, an input batch)."""
    jm = JaxDetSeg(backbone=JaxDetGuided(**NARROW, instance_impl="device"),
                   decode_head=JaxSegformerHead(2, 32))
    x = np.random.default_rng(11).standard_normal(
        (2, 64, 96, 3)).astype(np.float32)
    m = DetGuidedEncoderDecoder(CascadeMiTDetGuided(**NARROW),
                                SegformerHead([8, 16, 40, 64], 2, 32))
    # the variable tree through the porter (flax's `apply` refuses a tree
    # that misses or adds a variable), randomised, and carried back
    v = _randomize(to_jax_variables(m, "segmentor_det", **NARROW),
                   np.random.default_rng(13))   # text share 0.61
    return jm, v, load_jax_variables(m, "segmentor_det", v, **NARROW), x


@pytest.mark.parametrize("with_gt", [False, True])
def test_det_segmentor_matches_jax(pair, with_gt):
    jm, v, m, x = pair
    det_gt = None
    if with_gt:
        det_gt = np.zeros((2, 64, 96), np.float32)
        det_gt[0, 8:30, 10:60] = 1
        det_gt[0, 40:56, 20:90] = 1
        det_gt[1, 16:48, 40:80] = 1
        det_gt[1, 52:60, 4:30] = 1
    want, want_det = jm.apply(v, jnp.asarray(x), det_gt=None if det_gt is None
                              else jnp.asarray(det_gt))
    with torch.inference_mode():
        got, got_det = m(torch.from_numpy(x), None if det_gt is None
                         else torch.from_numpy(det_gt))
    want, want_det = np.asarray(want), np.asarray(want_det)
    assert got.shape == want.shape == (2, 64, 96, 2)
    assert got_det.shape == want_det.shape == (2, 16, 24, 2)
    np.testing.assert_allclose(got_det.numpy(), want_det, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if with_gt:
        text = pdg.nearest_resize_torch(torch.from_numpy(det_gt), (16, 24))
    else:
        # the text maps are the same on both sides, and not trivial
        margin = np.abs(want_det[..., 1] - want_det[..., 0])
        assert margin.min() > MARGIN
        text = torch.from_numpy(want_det.argmax(-1).astype(np.float32))
        assert 0.1 < text.mean() < 0.9
    inst = pdg.instance_labels(text)
    for b in range(2):   # at least two instances per image
        assert len(np.unique(inst[b].numpy())) >= 3


def test_init_segmentor_on_a_det_config_matches_jax():
    """`init_segmentor` -> `inference_segmentor` (slide, crop 64, stride 48)
    on the b0 TextSeg det config cut to the narrow width, with the JAX
    package's own `init_segmentor` variables (randomised)."""
    jm, v, cfg = jinf.init_segmentor(CONFIG, overrides=OVERRIDES)
    assert jm.backbone.instance_impl is None   # mesh-aware: device here
    v = _randomize(jax.tree_util.tree_map(np.asarray, v),
                   np.random.default_rng(4))
    m, pcfg = pinf.init_segmentor(CONFIG, v, device="cpu",
                                  overrides=OVERRIDES)
    assert pcfg.to_dict() == cfg.to_dict()
    assert isinstance(m, DetGuidedEncoderDecoder)
    img = np.random.default_rng(7).integers(0, 256, (96, 160, 3),
                                            dtype=np.uint8)
    want_map = jinf.inference_segmentor(jm, v, img, (64, 64), (48, 48))
    seg, logits = pinf.inference_segmentor(m, img, (64, 64), (48, 48),
                                           return_logits=True)
    assert seg.shape == (96, 160) and logits.shape == (1, 96, 160, 2)
    top = np.sort(logits[0].numpy(), -1)
    sure = top[..., -1] - top[..., -2] > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(seg[sure], np.asarray(want_map)[sure])
