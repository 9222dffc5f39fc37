"""The port's segmentation losses and metrics (fudanocr_tpu_torch/losses/
seg_losses.py, eval/seg_metrics.py) against the JAX package on the CPU, on
the same seeded numpy inputs, fp32: cross-entropy (with ignored pixels and
class weights), Lovász-softmax (the binary single-sort path and the
3-class per-class path, with an absent class), and accuracy, values and
gradients in the logits; `intersect_and_union` and `total_metrics`.

Lovász gradients of exactly tied errors depend on the sort order (the loss
value does not), so the logits are continuous random numbers. Tolerances:
values rtol 5e-6 (fp32 sums of ~1,500 terms in another order; measured up
to 1.05e-6), gradients atol 1e-7 on magnitudes ~1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.eval import seg_metrics as jsm
from fudanocr_tpu.losses import seg_losses as jsl
from fudanocr_tpu_torch.eval import seg_metrics as psm
from fudanocr_tpu_torch.losses import seg_losses as psl
from fudanocr_tpu_torch.train.seg import make_seg_train_step


def _data(seed, c, shape=(2, 24, 32), ignore=0.1, absent=None):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (c,)) * 2).astype(np.float32)
    labels = rng.integers(0, c, shape).astype(np.int32)
    if absent is not None:
        labels[labels == absent] = (absent + 1) % c
    labels[rng.random(shape) < ignore] = 255
    return logits, labels


def _both(jfn, pfn, logits, labels, **kw):
    jv, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(labels), **kw))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    pv = pfn(t, torch.from_numpy(labels), **kw)
    pv.backward()
    return float(jv), np.asarray(jg), pv.item(), t.grad.numpy()


def _check(jv, jg, pv, pg):
    np.testing.assert_allclose(pv, jv, rtol=5e-6)
    np.testing.assert_allclose(pg, jg, rtol=0, atol=1e-7)
    assert np.abs(jg).max() > 1e-6                 # not a trivial gradient


@pytest.mark.parametrize("c", [2, 3])
def test_cross_entropy_matches_jax(c):
    logits, labels = _data(0, c)
    _check(*_both(jsl.cross_entropy_loss, psl.cross_entropy_loss, logits,
                  labels))


def test_weighted_cross_entropy_matches_jax():
    logits, labels = _data(1, 3)
    w = np.float32([0.5, 2.0, 1.0])
    jv, jg = jax.value_and_grad(lambda x: jsl.cross_entropy_loss(
        x, jnp.asarray(labels), jnp.asarray(w)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    pv = psl.cross_entropy_loss(t, torch.from_numpy(labels),
                                torch.from_numpy(w))
    pv.backward()
    _check(float(jv), np.asarray(jg), pv.item(), t.grad.numpy())


@pytest.mark.parametrize("c,absent", [(2, None), (2, 1), (3, None), (3, 2)])
def test_lovasz_softmax_matches_jax(c, absent):
    logits, labels = _data(2 + c, c, absent=absent)
    _check(*_both(jsl.lovasz_softmax_loss, psl.lovasz_softmax_loss, logits,
                  labels))


def test_lovasz_of_an_all_ignored_map_is_zero():
    logits, labels = _data(6, 2, ignore=1.0)
    jv, _, pv, pg = _both(jsl.lovasz_softmax_loss, psl.lovasz_softmax_loss,
                          logits, labels)
    assert pv == jv == 0.0 and not pg.any()


@pytest.mark.parametrize("c", [2, 3])
def test_accuracy_matches_jax(c):
    logits, labels = _data(7, c)
    logits[0, :4] = 0.0                       # exact ties: first index wins
    want = float(jsl.seg_accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    got = psl.seg_accuracy(torch.from_numpy(logits),
                           torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("c", [2, 4])
def test_seg_metrics_match_jax(c):
    rng = np.random.default_rng(8)
    pred = rng.integers(0, c, (3, 20, 30)).astype(np.int32)
    label = rng.integers(0, c, (3, 20, 30)).astype(np.int32)
    label[rng.random(label.shape) < 0.2] = 255
    if c == 4:
        label[label == 3] = 0                 # a class absent from labels
    want = jsm.intersect_and_union(jnp.asarray(pred), jnp.asarray(label), c)
    got = psm.intersect_and_union(torch.from_numpy(pred),
                                  torch.from_numpy(label), c)
    hist_w = np.stack([np.asarray(a) for a in want]).astype(np.float64)
    hist_g = torch.stack(got).numpy().astype(np.float64)
    np.testing.assert_array_equal(hist_g, hist_w)
    jt, pt = jsm.total_metrics(*hist_w), psm.total_metrics(*hist_g)
    assert jt.keys() == pt.keys()
    for k in jt:
        np.testing.assert_array_equal(np.asarray(pt[k]), np.asarray(jt[k]),
                                      err_msg=k)


def test_only_the_sort_lovasz_is_ported():
    """Every `lovasz_impl` of JAX's step is taken ("bucketed" since the
    sort-free Lovász was ported; "auto" is the sort); any other raises."""
    for impl in ("sort", "auto", "bucketed"):
        assert callable(make_seg_train_step(torch.nn.Linear(1, 1), None,
                                            lovasz_impl=impl))
    with pytest.raises(ValueError, match="bucket"):
        make_seg_train_step(torch.nn.Linear(1, 1), None,
                            lovasz_impl="bucket")
