"""The rest of the port's segmentation losses (fudanocr_tpu_torch/losses/
seg_losses.py: `dice_loss`, `focal_loss`, `tversky_loss` and the sort-free
`lovasz_softmax_bucketed`) against the JAX package on the CPU, on the same
seeded numpy inputs, and the train step's `lovasz_impl` routes:

* each loss's value and its gradient in the logits, fp32, with ignored
  pixels, an absent class and, for the bucketed Lovász, tied errors (its
  weights are per bucket, so ties move neither side). Bars: values rtol
  5e-6 (fp32 sums in another order; measured up to 3.4e-7), gradients atol
  1e-8 on magnitudes ~1e-4 (measured up to 2.1e-10);
* the bucketed Lovász equals the exact one where no two distinct errors
  share a bucket (JAX's docstring claim; values rtol 5e-6, gradients atol
  1e-8), and its bucket edges are JAX's (errors on and beside them);
* `make_seg_train_step(lovasz_impl="bucketed")` against JAX's step (the
  plain model with CE + Lovász, tests/test_torch_seg_train.py's bars);
  "auto" is "sort" bit for bit; any other string raises;
* the bucketed det recipe's `SegTrainer` on 2 gloo ranks against one
  process in float64 (tests/torch_ddp_cases.py, 1e-9 of each group's
  scale), the histograms all-reduced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_cases as cases
from fudanocr_tpu.losses import seg_losses as jsl
from fudanocr_tpu_torch.losses import seg_losses as psl
from fudanocr_tpu_torch.train import seg as pseg
from test_torch_seg_train import _port_model, train_step_parity
from torch_threads import one_torch_thread  # noqa: F401

VALUE_RTOL, GRAD_ATOL = 5e-6, 1e-8


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    """The bucketed det case on 2 ranks (started first) and one process."""
    wait = cases.start_ranks(2, ["seg_bucketed"],
                             tmp_path_factory.mktemp("bucketed"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = cases.CASES["seg_bucketed"]()
    finally:
        torch.set_num_threads(n)
    return want, [r["seg_bucketed"] for r in wait()]


def _data(seed, c, shape=(2, 24, 32), absent=None, ties=False):
    rng = np.random.default_rng(seed)
    if ties:     # a few logit levels: many exactly equal errors
        logits = rng.integers(-2, 3, shape + (c,)).astype(np.float32)
    else:
        logits = (rng.standard_normal(shape + (c,)) * 2).astype(np.float32)
    labels = rng.integers(0, c, shape).astype(np.int32)
    if absent is not None:
        labels[labels == absent] = (absent + 1) % c
    labels[rng.random(shape) < 0.1] = 255
    return logits, labels


def _value_grad(fn, logits, labels, **kw):
    t = torch.from_numpy(logits).requires_grad_()
    v = fn(t, torch.from_numpy(labels), **kw)
    v.backward()
    return v.item(), t.grad.numpy()


def _against_jax(name, logits, labels, **kw):
    jv, jg = jax.value_and_grad(lambda x: getattr(jsl, name)(
        x, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    pv, pg = _value_grad(getattr(psl, name), logits, labels, **kw)
    np.testing.assert_allclose(pv, float(jv), rtol=VALUE_RTOL)
    np.testing.assert_allclose(pg, np.asarray(jg), rtol=0, atol=GRAD_ATOL)
    assert np.abs(np.asarray(jg)).max() > 1e-6     # not a trivial gradient


@pytest.mark.parametrize("name,kw,c,absent", [
    (name, {}, c, absent) for name in ("dice_loss", "focal_loss",
                                       "tversky_loss")
    for c, absent in ((2, None), (3, 2))] + [
    ("dice_loss", {"smooth": 0.5}, 2, None),
    ("focal_loss", {"gamma": 1.5, "alpha": 0.5}, 2, None),
    ("tversky_loss", {"alpha": 0.6, "beta": 0.4}, 2, None)])
def test_losses_match_jax(name, kw, c, absent):
    _against_jax(name, *_data(3 + c, c, absent=absent), **kw)


@pytest.mark.parametrize("absent,ties,k", [
    (None, False, 1024), (1, False, 1024), (None, True, 1024),
    (None, False, 16), (0, True, 16)])
def test_lovasz_bucketed_matches_jax(absent, ties, k):
    _against_jax("lovasz_softmax_bucketed",
                 *_data(9, 2, absent=absent, ties=ties), num_buckets=k)


def test_lovasz_bucketed_boundaries_are_jax():
    """Errors on and one float32 step beside the bucket edges (k - 1) e +
    0.5 = n (after the softmax 16 of the 42 pixels sit exactly on one, the
    rest within 1.4e-6), where a bucket index formed in another precision
    or order would move: each pixel's gradient (its bucket's weight)
    equals JAX's."""
    k = 16
    levels = np.arange(1, k - 1, dtype=np.float32) - 0.5
    e = np.concatenate([levels, np.nextafter(levels, 0),
                        np.nextafter(levels, 2 * k)]) / np.float32(k - 1)
    p0 = np.float32(1) - e                       # label 0: error 1 - p0
    logits = np.stack([np.log(p0 / (1 - p0)), np.zeros_like(p0)], -1)
    labels = np.zeros(len(e), np.int32)
    labels[::3] = 1
    _against_jax("lovasz_softmax_bucketed", logits[None, None],
                 labels[None, None], num_buckets=k)


def test_lovasz_bucketed_equals_sort_without_shared_buckets():
    """Distinct errors in distinct buckets, each within a tenth of a level
    of its bucket's centre: the bucketed value and gradients are the exact
    Lovász's."""
    k, n = 1024, 300
    rng = np.random.default_rng(12)
    centres = rng.choice(np.arange(1, k - 1), n, replace=False) / (k - 1)
    e = centres + rng.uniform(-0.1, 0.1, n) / (k - 1)
    labels = rng.integers(0, 2, n).astype(np.int32)
    p0 = np.where(labels == 0, 1 - e, e)
    logits = np.stack([np.log(p0 / (1 - p0)), np.zeros(n)],
                      -1).astype(np.float32)
    labels[:5] = 255
    args = (logits[None, None], labels[None, None])
    bv, bg = _value_grad(psl.lovasz_softmax_bucketed, *args, num_buckets=k)
    sv, sg = _value_grad(psl.lovasz_softmax_loss, *args)
    np.testing.assert_allclose(bv, sv, rtol=VALUE_RTOL)
    np.testing.assert_allclose(bg, sg, rtol=0, atol=GRAD_ATOL)
    assert np.abs(sg).max() > 1e-4


def test_lovasz_bucketed_takes_two_classes():
    logits, labels = _data(1, 3)
    with pytest.raises(ValueError, match="two classes"):
        psl.lovasz_softmax_bucketed(torch.from_numpy(logits),
                                    torch.from_numpy(labels))


def test_bucketed_train_step_matches_jax():
    train_step_parity(False, lovasz_impl="bucketed")


def test_auto_is_sort_and_other_routes_raise():
    """One CE + Lovász step from the same weights and generator: "auto"
    gives the "sort" step's metrics and parameters bit for bit; "bucketed"
    another Lovász term; an unknown route raises."""
    rng = np.random.default_rng(4)
    batch = {"img": torch.from_numpy(rng.standard_normal(
        (2, 32, 32, 3)).astype(np.float32)),
        "gt_seg": torch.from_numpy(rng.integers(0, 2, (2, 32, 32)))}
    start = _port_model(det=False).state_dict()
    runs = {}
    for impl in ("sort", "auto", "bucketed"):
        m = _port_model(det=False)
        m.load_state_dict(start)
        step = pseg.make_seg_train_step(
            m, pseg.make_seg_optimizer(m, total_iters=10),
            {"ce": 1.0, "lovasz": 1.0}, lovasz_impl=impl)
        out = step(batch, torch.Generator().manual_seed(0))
        runs[impl] = ({k: v.item() for k, v in out.items()}, m.state_dict())
    assert runs["auto"][0] == runs["sort"][0]
    assert all(torch.equal(v, runs["sort"][1][k])
               for k, v in runs["auto"][1].items())
    assert runs["bucketed"][0]["ce"] == runs["sort"][0]["ce"]
    assert runs["bucketed"][0]["lovasz"] == pytest.approx(
        runs["sort"][0]["lovasz"], rel=1e-2)
    with pytest.raises(ValueError, match="lovasz_impl"):
        pseg.make_seg_train_step(m, None, lovasz_impl="exact")
    with pytest.raises(ValueError, match="lovasz_impl"):
        pseg.SegTrainer(m, None, None, lovasz_impl="Bucketed")


def test_bucketed_ranks_equal_one_process(ddp_runs):
    want, got = ddp_runs
    assert len(got) == 2 and want["moved"] > 1e-6
    for rank, res in enumerate(got):
        cases.assert_same_run(res, want, f"seg_bucketed rank {rank} of 2")
