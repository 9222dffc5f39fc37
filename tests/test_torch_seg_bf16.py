"""The seg models with `dtype=torch.bfloat16` (CascadeMiT,
CascadeMiTDetGuided, SegformerHead, the segmentors and `slide_inference`)
against the JAX package's bf16 and fp32 forwards on the CPU, on the same
weights (the narrow cut of tests/test_torch_seg_model.py: embed 8, one
layer a stage, heads (1, 2, 5, 8), moved with `load_jax_variables`) and
seeded numpy inputs.

Bars, those of tests/test_torch_bf16_inference.py: `jaxs` is JAX's bf16
output's distance from JAX's fp32 output (max abs, mean abs);

* the port's bf16 output is no further from JAX's fp32 output than
  2 x jaxs, in max and in mean;
* it is at least jaxs / 4 away in mean (an fp32 port sits at ~1e-6);
* class maps equal JAX's bf16 ones wherever JAX's bf16 top-2 margin
  exceeds twice the largest difference measured between the two bf16
  outputs.

The det-guided forward is checked with `det_gt` given (the masks come
from it) and without (the masks come from the bf16 det logits). Without
it, the text map is the soft-argmax of two bf16 logits: where they tie
it is 0.5, where they nearly tie a rounding decides it, and the two
packages round at other places, so their text maps, and through them the
region ids, may differ at such pixels. The test says how many pixels
differ (no more than 1 % of them may), holds the det logits to the bars
everywhere, and holds the seg logits to them on the images whose text
maps agree.

Measured (CPU, torch 2.13, jax 0.9; max / mean from JAX fp32, the port
then jaxs; each test prints its numbers with `-s`): plain logits 0.0212 /
3.52e-3, 0.0277 / 3.69e-3; slide 0.0178 / 2.90e-3, 0.0176 / 2.93e-3; det
with det_gt, seg logits 0.0321 / 4.65e-3, 0.0448 / 5.55e-3, det logits
0.0211 / 5.02e-3, 0.0244 / 5.16e-3; without det_gt the text maps differ
at 2 of 1536 pixels (one of them the port's only tie), image 1 agrees,
its seg logits 0.0303 / 5.17e-3, 0.0338 / 4.64e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.seg import CascadeMiT as JaxCascadeMiT
from fudanocr_tpu.models.seg import CascadeMiTDetGuided as JaxDetGuided
from fudanocr_tpu.models.seg import DetGuidedEncoderDecoder as JaxDetSeg
from fudanocr_tpu.models.seg import EncoderDecoder as JaxSeg
from fudanocr_tpu.models.seg import SegformerHead as JaxSegformerHead
from fudanocr_tpu.models.seg.det_guided import soft_argmax as jax_soft_argmax
from fudanocr_tpu.models.seg.encoder_decoder import (
    slide_inference as jax_slide_inference)
from fudanocr_tpu_torch.models.seg import (CascadeMiT, CascadeMiTDetGuided,
                                           DetGuidedEncoderDecoder,
                                           EncoderDecoder, SegformerHead,
                                           slide_inference)
from fudanocr_tpu_torch.models.seg.det_guided import soft_argmax
from fudanocr_tpu_torch.utils.weights import load_jax_variables
from test_torch_seg_model import _randomize
from torch_threads import one_torch_thread  # noqa: F401

NARROW = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
              sr_ratios=(8, 4, 2, 1))
HEAD_IN = [8, 16, 40, 64]
BF16 = torch.bfloat16


def _dist(a, b) -> tuple:
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.max()), float(d.mean())


def _check_bars(what: str, got, want32, want16) -> None:
    ours, jaxs = _dist(got, want32), _dist(want16, want32)
    print(f"{what}: port bf16 from JAX fp32 max {ours[0]:.4g} mean "
          f"{ours[1]:.4g}; JAX bf16 from JAX fp32 max {jaxs[0]:.4g} mean "
          f"{jaxs[1]:.4g}")
    assert ours[0] <= 2 * jaxs[0], (what, "max", ours, jaxs)
    assert ours[1] <= 2 * jaxs[1], (what, "mean", ours, jaxs)
    assert ours[1] >= jaxs[1] / 4, (what, "fp32 port?", ours, jaxs)


def _check_maps(what: str, got, want16) -> None:
    err = _dist(got, want16)[0]
    top = np.sort(want16, -1)
    sure = top[..., -1] - top[..., -2] > 2 * err
    same = got.argmax(-1) == want16.argmax(-1)
    print(f"{what}: class maps equal at {int(same.sum())} of {same.size} "
          f"pixels and at all {int(sure.sum())} whose JAX bf16 margin "
          f"exceeds {2 * err:.4g}: {bool(same[sure].all())}")
    assert sure.mean() > 0.5 and same[sure].all()


def _jax(det: bool, dtype):
    head = JaxSegformerHead(2, 32, dtype=dtype)
    if det:
        return JaxDetSeg(backbone=JaxDetGuided(**NARROW, dtype=dtype,
                                               instance_impl="device"),
                         decode_head=head)
    return JaxSeg(backbone=JaxCascadeMiT(**NARROW, dtype=dtype),
                  decode_head=head)


def _port(det: bool, v):
    backbone = (CascadeMiTDetGuided if det else CascadeMiT)(**NARROW,
                                                            dtype=BF16)
    m = (DetGuidedEncoderDecoder if det else EncoderDecoder)(
        backbone, SegformerHead(HEAD_IN, 2, 32, dtype=BF16))
    return load_jax_variables(m, "segmentor_det" if det else "segmentor", v,
                              **NARROW).eval()


def _variables(det: bool, seed: int):
    v = _jax(det, None).init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 64, 64, 3)))
    return _randomize(jax.tree_util.tree_map(np.asarray, v),
                      np.random.default_rng(seed))


@pytest.fixture(scope="module")
def plain():
    return _variables(False, 0)


def _image(seed, hw=(96, 128), n=2):
    return np.random.default_rng(seed).standard_normal((n, *hw, 3)).astype(
        np.float32)


def test_segmentor_bf16_matches_jax(plain):
    """Logits of the plain segmentor at 96x128: bf16 out, fp32 parameters."""
    x = _image(1)
    want32 = np.asarray(_jax(False, None).apply(plain, jnp.asarray(x)))
    want16 = np.asarray(_jax(False, jnp.bfloat16).apply(
        plain, jnp.asarray(x)).astype(jnp.float32))
    m = _port(False, plain)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.inference_mode():
        out = m(torch.from_numpy(x))
    assert out.dtype == BF16 and out.shape == (2, 96, 128, 2)
    got = out.float().numpy()
    _check_bars("plain logits", got, want32, want16)
    _check_maps("plain", got, want16)


def test_slide_inference_bf16_matches_jax(plain):
    """Slide at crop 64, stride 48 over 96x160 (a 2 x 3 grid, the last
    column clamped), 2 crops a forward; the sums in float32."""
    x = _image(5, (96, 160))
    outs = {}
    for name, dt in (("fp32", None), ("bf16", jnp.bfloat16)):
        jm = _jax(False, dt)
        fwd = jax.jit(lambda t, jm=jm: jm.apply(plain, t))
        outs[name] = np.asarray(jax_slide_inference(
            fwd, jnp.asarray(x), (64, 64), (48, 48), max_fwd_images=4))
    m = _port(False, plain)
    with torch.inference_mode():
        out = slide_inference(m, torch.from_numpy(x), (64, 64), (48, 48),
                              max_fwd_images=4)
    assert out.dtype == torch.float32
    got = out.numpy()
    _check_bars("slide logits", got, outs["fp32"], outs["bf16"])
    _check_maps("slide", got, outs["bf16"])


@pytest.fixture(scope="module")
def det():
    return _variables(True, 2)


def test_det_guided_bf16_with_det_gt_matches_jax(det):
    x = _image(3)
    gt = (np.random.default_rng(4).random((2, 96, 128)) < 0.4).astype(
        np.int32)
    outs = {}
    for name, dt in (("fp32", None), ("bf16", jnp.bfloat16)):
        logits, det_logits = _jax(True, dt).apply(det, jnp.asarray(x),
                                                  det_gt=jnp.asarray(gt))
        outs[name] = (np.asarray(logits.astype(jnp.float32)),
                      np.asarray(det_logits.astype(jnp.float32)))
    m = _port(True, det)
    with torch.inference_mode():
        logits, det_logits = m(torch.from_numpy(x),
                               det_gt=torch.from_numpy(gt))
    assert logits.dtype == det_logits.dtype == BF16
    for i, what in enumerate(("seg logits", "det logits")):
        got = (logits, det_logits)[i].float().numpy()
        _check_bars(f"det_gt given, {what}", got, outs["fp32"][i],
                    outs["bf16"][i])
    _check_maps("det_gt given", logits.float().numpy(), outs["bf16"][0])


def test_det_guided_bf16_on_its_det_logits_matches_jax(det):
    """Masks from the bf16 det logits (JAX op by op: jitted on the CPU its
    text map has NaN pixels, ROADMAP C10)."""
    x = _image(6)
    outs = {}
    for name, dt in (("fp32", None), ("bf16", jnp.bfloat16)):
        logits, det_logits = _jax(True, dt).apply(det, jnp.asarray(x))
        outs[name] = (np.asarray(logits.astype(jnp.float32)),
                      np.asarray(det_logits.astype(jnp.float32)),
                      np.asarray(jax_soft_argmax(det_logits)))
    m = _port(True, det)
    with torch.inference_mode():
        logits, det_logits = m(torch.from_numpy(x))
        text = soft_argmax(det_logits).numpy()
    _check_bars("no det_gt, det logits", det_logits.float().numpy(),
                outs["fp32"][1], outs["bf16"][1])
    differ = text != outs["bf16"][2]
    agree = [b for b in range(x.shape[0]) if not differ[b].any()]
    print(f"no det_gt: text maps differ from JAX bf16's at "
          f"{int(differ.sum())} of {differ.size} pixels (JAX bf16 ties "
          f"{int((outs['bf16'][2] == 0.5).sum())}, the port's "
          f"{int((text == 0.5).sum())}); images that agree: {agree}")
    assert 0.05 < (text > 0).mean() < 0.95        # the masks are not trivial
    assert differ.mean() < 0.01
    if agree:
        got = logits.float().numpy()[agree]
        _check_bars("no det_gt, seg logits where the text maps agree", got,
                    outs["fp32"][0][agree], outs["bf16"][0][agree])
