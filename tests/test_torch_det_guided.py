"""The det-guided segmentation slice of the port (fudanocr_tpu_torch/models/
seg/det_guided.py, the region route of cascade_mit.EfficientAttention,
DetGuidedEncoderDecoder, porter `segmentor_det`, `init_segmentor` on the
`*_det` configs) against the JAX package on the CPU:

* `instance_labels` EQUAL to the JAX `instance_labels_device` (the same
  ids, not only the same partition) on the noise, serpentine and spiral
  maps of tests/test_det_guided.py and on serpentines and a spiral at the
  256 x 256 text map of a 1024 x 1024 crop, in a few rounds under its cap;
  the same partition as OpenCV's contour fill on maps without holes;
* `soft_argmax` (with exact ties), `nearest_resize_torch`,
  `region_vectors` and `region_attn_mask` exact against JAX;
* a narrow CascadeMiTDetGuided (embed_dims 8, one layer per stage) and
  DetGuidedEncoderDecoder with the JAX variables carried across by the
  porter, against JAX with `instance_impl="device"`: logits and det logits
  fp32 atol 2e-4 (the module-parity bar, ROADMAP.md), with and without
  `det_gt`;
* which attention function each branch calls, inside and outside the
  region gate.

The segmentor parity runs in tests/test_torch_det_guided_model.py and the
sweep over the 30 `*_det` configs in tests/test_torch_det_guided_sweep*.py
(split so that the files spread over the workers); they import the
constants below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.seg import det_guided as jdg
from fudanocr_tpu_torch.apps.seg import inference as pinf
from fudanocr_tpu_torch.core.config import load_config
from fudanocr_tpu_torch.models.seg import cascade_mit as pcm
from fudanocr_tpu_torch.models.seg import det_guided as pdg
from fudanocr_tpu_torch.models.seg import (CascadeMiTDetGuided,
                                           DetGuidedEncoderDecoder)

ATOL = 2e-4     # the module-parity bar (ROADMAP.md)
MARGIN = 1e-3   # every det-logit margin must exceed it (same text maps)
NARROW = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
              sr_ratios=(8, 4, 2, 1))
CONFIG = "configs/seg/textformer_b0_textseg_det.yaml"
OVERRIDES = ("model.backbone.embed_dims=8",
             "model.backbone.num_layers=[1, 1, 1, 1]",
             "model.decode_head.channels=32")


def _serpentine(n, period=4):
    """One n x n snake: a full row every `period` rows, joined at
    alternating ends."""
    serp = np.zeros((1, n, n), np.float32)
    for r in range(0, n, period):
        serp[0, r, :] = 1
        if (r // period) % 2 == 0 and r + period < n:
            serp[0, r:r + period, n - 1] = 1
        elif r + period < n:
            serp[0, r:r + period, 0] = 1
    return serp


def _spiral(n):
    spiral = np.zeros((1, n + 1, n + 1), np.float32)
    x0, x1, y0, y1 = 0, n, 0, n
    while x0 < x1:
        spiral[0, y0, x0:x1 + 1] = 1
        spiral[0, y0:y1 + 1, x1] = 1
        spiral[0, y1, x0:x1 + 1] = 1
        spiral[0, y0 + 2:y1 + 1, x0] = 1
        x0 += 2; y0 += 2; x1 -= 2; y1 -= 2
    return spiral


def _maps():
    """The adversarial maps of tests/test_det_guided.py:143-161, and the
    same shapes at the 256 x 256 text map of a 1024 x 1024 crop."""
    rng = np.random.default_rng(0)
    noise = (rng.random((2, 48, 48)) > 0.4).astype(np.float32)
    return {"noise": noise, "serpentine": _serpentine(64),
            "spiral": _spiral(64), "serpentine_256": _serpentine(256),
            "serpentine_256_dense": _serpentine(256, period=2),
            "spiral_256": _spiral(256)}


# the rounds each map takes (at most), far under the cap of
# 4 * ceil(log2(H * W)) + 64 = 128 at 256 x 256
ROUNDS = {"noise": 20, "serpentine": 20, "spiral": 20, "serpentine_256": 16,
          "serpentine_256_dense": 16, "spiral_256": 16}


@pytest.mark.parametrize("name", list(ROUNDS))
def test_instance_labels_equal_jax_device_labels(name):
    binary = _maps()[name]
    want = np.asarray(jdg.instance_labels_device(jnp.asarray(binary)))
    got = pdg.instance_labels(torch.from_numpy(binary)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 1 <= pdg.instance_labels.rounds <= ROUNDS[name]


def test_instance_labels_raise_past_their_cap(monkeypatch):
    """A round that never reaches a fixed point (it flips the label of
    pixel 0 between 0 and 1) raises at the cap rather than return a partial
    labelling."""
    real = pdg._label_round
    seen = []

    def restless(lab, *args):
        seen.append(1)
        out = real(lab, *args).clone()
        out[0, 0] = len(seen) % 2
        return out

    monkeypatch.setattr(pdg, "_label_round", restless)
    with pytest.raises(RuntimeError, match="no fixed point after 128 "):
        pdg.instance_labels(torch.from_numpy(_maps()["serpentine_256"]))
    assert len(seen) == 128


def test_instance_partition_equals_cv2_without_holes():
    pytest.importorskip("cv2")
    binary = np.zeros((2, 24, 24), np.int32)
    binary[0, 2:6, 3:9] = 1
    binary[0, 10:15, 12:20] = 1
    binary[0, 20:22, 0:4] = 1
    binary[0, 6:10, 8] = 1          # a tail under the first block
    binary[1, 5:9, 5:9] = 1
    want = jdg._instance_labels_host(binary)
    got = pdg.instance_labels(torch.from_numpy(binary).float()).numpy()
    for b in range(2):
        w, g = want[b].reshape(-1), got[b].reshape(-1)
        np.testing.assert_array_equal(w[:, None] == w[None, :],
                                      g[:, None] == g[None, :])
    assert (got[binary == 0] == 0).all()


def test_soft_argmax_resize_and_region_vectors_equal_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 12, 20, 2)).astype(np.float32)
    logits[0, :3, :, 1] = logits[0, :3, :, 0]          # exact ties -> 0.5
    want = np.asarray(jdg.soft_argmax(jnp.asarray(logits)))
    got = pdg.soft_argmax(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, :3] == 0.5).all() and set(np.unique(got)) == {0, 0.5, 1}

    region = rng.integers(0, 5, (2, 12, 20)).astype(np.float32) * 0.5
    for out_hw in [(6, 10), (12, 20), (5, 7), (9, 13), (1, 1)]:
        np.testing.assert_array_equal(
            pdg.nearest_resize_torch(torch.from_numpy(region),
                                     out_hw).numpy(),
            np.asarray(jdg.nearest_resize_torch(jnp.asarray(region),
                                                out_hw)))
    for hw, sr in [((12, 20), 4), ((6, 10), 2), ((3, 5), 8), ((5, 7), 1)]:
        got = pdg.region_vectors(torch.from_numpy(region), hw, sr)
        want = jdg.region_vectors(jnp.asarray(region), hw, sr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            pdg.region_attn_mask(torch.from_numpy(region), hw, sr).numpy(),
            np.asarray(jdg.region_attn_mask(jnp.asarray(region), hw, sr)))


@pytest.mark.parametrize("name", ["textformer_b0_bts_det",
                                  "textformer_b3_mlt_det",
                                  "textformer_b5_totaltext_det"])
def test_build_model_on_det_configs(name):
    cfg = load_config(f"configs/seg/{name}.yaml")
    m = pinf.build_model(cfg)
    b = cfg.model.backbone
    assert isinstance(m, DetGuidedEncoderDecoder) and not m.training
    assert isinstance(m.backbone, CascadeMiTDetGuided)
    assert m.backbone.text_sa_1.attn.attn.in_proj_weight.shape == (
        3 * b.embed_dims, b.embed_dims)
    assert len(m.backbone.layers[0][1]) == b.num_layers[0]


def test_region_routing(monkeypatch):
    """Which attention function a branch calls: inside the region gate
    `region_flash_mha`; outside it the plain path with the materialised
    mask (never B7 or B5, even where B5's gate holds); without a region the
    PR-3 routes; `kernels=False` plain everywhere. The routes agree."""
    calls = []
    for name in ("region_flash_mha", "packed_flash_mha", "flash_mha"):
        real = getattr(pcm, name)
        monkeypatch.setattr(pcm, name, lambda *a, _n=name, _f=real: (
            calls.append(_n), _f(*a))[1])
    gen = torch.Generator().manual_seed(0)
    for (c, heads, sr, hw), want_region, want_plain in [
            ((32, 1, 8, (128, 64)), ["region_flash_mha"],
             ["packed_flash_mha"]),                  # Lq 8192, Lkv 128
            ((32, 2, 1, (16, 32)), [], ["flash_mha"]),   # Lq = Lkv = 512
            ((32, 1, 8, (32, 32)), [], [])]:            # Lkv 16
        att = pcm.EfficientAttention(c, heads, sr)
        ref = pcm.EfficientAttention(c, heads, sr, kernels=False)
        ref.load_state_dict(att.state_dict())
        x = torch.randn(2, hw[0] * hw[1], c, generator=gen)
        hk, wk = max(hw[0] // sr, 1), max(hw[1] // sr, 1)
        region = (torch.randint(0, 3, (2, hw[0] * hw[1]), generator=gen)
                  .float() / 2,
                  torch.randint(0, 3, (2, hk * wk), generator=gen).float() / 2)
        with torch.inference_mode():
            calls.clear()
            got = att(x, hw, region)
            assert calls == want_region, (c, hw)
            calls.clear()
            att(x, hw)
            assert calls == want_plain, (c, hw)
            calls.clear()
            want = ref(x, hw, region)
            assert calls == []
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
