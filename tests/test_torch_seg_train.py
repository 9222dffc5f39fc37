"""The segmentation training slice of the port (fudanocr_tpu_torch/train/
seg.py, the SegAdam optimizer of train/state.py, the train modes of
models/seg, data/seg_dataset.py) against the JAX package on the CPU, on the
same seeded numpy inputs and weights, fp32. The step parity
(`train_step_parity`) runs from tests/test_torch_seg_train_step.py (plain
recipe, with the trainer) and tests/test_torch_seg_train_det_step.py (det
recipe), so that the three files spread over the workers:

* one `make_seg_train_step` of a narrow CascadeMiT segmentor (embed 8,
  layers (1, 1, 1, 1), heads (1, 2, 5, 8), sr (8, 4, 2, 1), head 32
  channels) with CE, and of the det-guided one (JAX `instance_impl=
  "device"`, whose labelling the port reproduces id for id) with CE +
  Lovász and the det loss x 0.1 (the JAX det step op by op: jitted on
  the CPU its text map has NaN pixels), at crop 64², batch 2, drop-path 0 and
  dropout 0 (neither can be matched across the packages' generators): the
  loss and its terms (rel 1e-5), every parameter's gradient (rel 1e-3, in
  the JAX layout through the porter; gradients that are zero up to
  rounding, the conv biases in front of a train-mode BatchNorm, held to
  1e-6 of the largest) and the new BatchNorm statistics (atol 1e-5);
* SegAdam against optax's `make_seg_optimizer` after the warmup (head
  lr x10, no decay on 1-D tensors), and `poly_schedule` against JAX's;
* drop-path and dropout: keep rates, scaling and generator determinism;
* the static batches of data/seg_dataset.py against JAX's, and
  `SegTrainer.train()` / `evaluate()` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fudanocr_tpu.core.mesh import make_mesh_for_batch
from fudanocr_tpu.data import seg_dataset as jds
from fudanocr_tpu.models.seg import CascadeMiT as JaxCascadeMiT
from fudanocr_tpu.models.seg import CascadeMiTDetGuided as JaxDetGuided
from fudanocr_tpu.models.seg import DetGuidedEncoderDecoder as JaxDetSeg
from fudanocr_tpu.models.seg import EncoderDecoder as JaxSeg
from fudanocr_tpu.models.seg import SegformerHead as JaxSegformerHead
from fudanocr_tpu.train import seg as jseg
from fudanocr_tpu.train.state import TrainState
from fudanocr_tpu_torch.data import seg_dataset as pds
from fudanocr_tpu_torch.models.seg import (CascadeMiT, CascadeMiTDetGuided,
                                           DetGuidedEncoderDecoder,
                                           EncoderDecoder, SegformerHead)
from fudanocr_tpu_torch.models.seg.cascade_mit import (drop_path,
                                                       drop_path_rates)
from fudanocr_tpu_torch.train import seg as pseg
from fudanocr_tpu_torch.utils.weights import (grad_state_dict,
                                              load_jax_variables,
                                              to_jax_variables)

NARROW = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
              sr_ratios=(8, 4, 2, 1))
HEAD_IN = [8, 16, 40, 64]
LOSS_REL, GRAD_REL, STATS_ATOL = 1e-5, 1e-3, 1e-5
MARGIN = 1e-3   # every det-logit margin must exceed it (same text maps)


def _port_model(det: bool):
    backbone = (CascadeMiTDetGuided if det else CascadeMiT)(
        **NARROW, drop_path_rate=0.0)
    head = SegformerHead(HEAD_IN, 2, 32, dropout_ratio=0.0)
    return (DetGuidedEncoderDecoder if det else EncoderDecoder)(backbone,
                                                                head)


def _jax_model(det: bool):
    head = JaxSegformerHead(2, 32, dropout_ratio=0.0)
    if det:
        return JaxDetSeg(backbone=JaxDetGuided(**NARROW, drop_path_rate=0.0,
                                               instance_impl="device"),
                         decode_head=head)
    return JaxSeg(backbone=JaxCascadeMiT(**NARROW, drop_path_rate=0.0),
                  decode_head=head)


def _randomize(variables, rng):
    """Random weights (fan-in scaled), BN statistics away from 0 / 1, LN
    scales away from 1; the det classifier scaled up so that the det logit
    margins clear MARGIN."""
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


def _blobs(rng, n, hw, count):
    m = np.zeros((n,) + hw, np.int32)
    for b in range(n):
        for _ in range(count):
            y, x = rng.integers(0, hw[0] - 16, 2)
            h, w = rng.integers(4, 16, 2)
            m[b, y:y + h, x:x + w] = 1
    return m


def _batch(seed, n=2, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    gt = _blobs(rng, n, hw, 5)
    det = np.maximum(gt, np.roll(gt, 2, axis=1))      # a dilated det mask
    gt[0, :4] = 255                                    # ignored pixels
    return {"img": rng.standard_normal((n,) + hw + (3,)).astype(np.float32),
            "gt_seg": gt, "gt_det": det.astype(np.int32),
            "valid": np.ones((n,), np.float32)}


def _capture_grads():
    """An optax transformation that keeps the gradients as its state and
    leaves the parameters unchanged."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(zeros,
                                        lambda g, s, p=None: (zeros(g), g))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def train_step_parity(det: bool, lovasz_impl: str = None) -> None:
    """One train step of either recipe against JAX (see the module
    docstring); the step files run it per recipe. With `lovasz_impl` the
    step adds Lovász to CE on either model and both packages take that
    Lovász route."""
    porter = "segmentor_det" if det else "segmentor"
    weights = ({"ce": 1.0, "lovasz": 1.0} if det or lovasz_impl
               else {"ce": 1.0})
    impl = {"lovasz_impl": lovasz_impl} if lovasz_impl else {}
    m = _port_model(det)
    v = _randomize(to_jax_variables(m, porter, **NARROW),
                   np.random.default_rng(21 + det))
    batch = _batch(5 + det)
    if not det:
        del batch["gt_det"]
        batch["valid"][1] = 0.0                 # a padded tail sample
    jm = _jax_model(det)
    state = TrainState.create(v["params"], v["batch_stats"],
                              _capture_grads())
    step = jseg.make_seg_train_step(jm, make_mesh_for_batch(2), weights,
                                    det_loss_ratio=0.1, wrap_jit=False,
                                    **impl)
    if not det:
        # under jit, XLA:CPU fuses the det model's soft_argmax,
        # softmax(logits * 1e10), into NaN at some pixels (ROADMAP C10):
        # the det step runs op by op
        step = jax.jit(step)
    new_state, want = step(state, {k: jnp.asarray(a)
                                   for k, a in batch.items()},
                           jax.random.PRNGKey(0))
    if det:   # the text maps are the same on both sides, and not trivial
        _, det_logits = jm.apply(v, jnp.asarray(batch["img"]), train=True,
                                 mutable=["batch_stats"])[0]
        margin = np.abs(np.diff(np.asarray(det_logits), axis=-1))
        assert margin.min() > MARGIN
        assert 0.1 < (np.asarray(det_logits).argmax(-1)).mean() < 0.9

    load_jax_variables(m, porter, v, **NARROW)
    opt = pseg.make_seg_optimizer(m, 6e-5, total_iters=1000)
    pstep = pseg.make_seg_train_step(m, opt, weights, det_loss_ratio=0.1,
                                     **impl)
    got = pstep({k: torch.from_numpy(a) for k, a in batch.items()},
                torch.Generator().manual_seed(0))

    want_keys = ({"loss", "acc"} | set(weights)
                 | ({"det"} if det else set()))
    assert set(got) == set(want) == want_keys
    for k in want_keys:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=LOSS_REL, err_msg=k)
    back = to_jax_variables(grad_state_dict(m), porter, **NARROW)
    got_s, want_s = _leaves(back["batch_stats"]), _leaves(
        new_state.batch_stats)
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=0,
                                   atol=STATS_ATOL, err_msg=k)
    got_g, want_g = _leaves(back["params"]), _leaves(new_state.opt_state)
    assert got_g.keys() == want_g.keys()
    top = max(np.linalg.norm(w) for w in want_g.values())
    n_zero = 0
    for k, w in want_g.items():
        diff = np.linalg.norm(got_g[k] - w)
        if np.linalg.norm(w) <= 1e-6 * top:
            n_zero += 1
            assert diff <= 1e-6 * top, k
        else:
            assert diff <= GRAD_REL * np.linalg.norm(w), (k, diff)
    assert n_zero < len(want_g) // 4


def test_poly_schedule_matches_jax():
    jsched = jseg.poly_schedule(6e-5, 160_000)
    psched = pseg.poly_schedule(6e-5, 160_000)
    for step in (0, 1, 750, 1499, 1500, 1501, 80_000, 159_999, 160_000,
                 200_000):
        np.testing.assert_allclose(psched(step), float(jsched(step)),
                                   rtol=1e-6, atol=1e-18, err_msg=str(step))
    assert psched(0) == pytest.approx(6e-11)


class _TwoPart(torch.nn.Module):
    """A stand-in segmentor: `backbone` and `decode_head` with 2-D and 1-D
    parameters."""

    def __init__(self, params):
        super().__init__()
        for top, leaves in params.items():
            mod = torch.nn.Module()
            for name, a in leaves.items():
                setattr(mod, name, torch.nn.Parameter(torch.from_numpy(
                    a.copy())))
            self.add_module(top, mod)


def test_seg_optimizer_matches_optax_after_warmup():
    """Three updates from count 1500 (the end of the warmup): coupled
    decay on 2-D tensors only, the decode head's lr x10."""
    rng = np.random.default_rng(9)
    params = {top: {"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal((4,)).astype(np.float32)}
              for top in ("backbone", "decode_head")}
    tx = jseg.make_seg_optimizer(params, 6e-5, total_iters=160_000)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    st = jax.tree_util.tree_map(
        lambda s: s._replace(count=jnp.asarray(1500, jnp.int32))
        if isinstance(s, optax.ScaleByScheduleState) else s, st,
        is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))
    model = _TwoPart(params)
    opt = pseg.make_seg_optimizer(model, 6e-5, total_iters=160_000)
    opt.count = 1500
    for i in range(3):
        grads = {top: {k: rng.standard_normal(a.shape).astype(np.float32)
                       for k, a in leaves.items()}
                 for top, leaves in params.items()}
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), st,
                            jp)
        jp = optax.apply_updates(jp, upd)
        for top, leaves in grads.items():
            for k, g in leaves.items():
                getattr(getattr(model, top), k).grad = torch.from_numpy(g)
        lr = opt.step()
        assert lr == pytest.approx(float(jseg.poly_schedule(
            6e-5, 160_000)(1500 + i)), rel=1e-6)
    for top in params:
        for k in params[top]:
            got = getattr(getattr(model, top), k).detach().numpy()
            want = np.asarray(jp[top][k])
            moved = np.abs(want - params[top][k]).max()
            assert moved > 1e-5          # the updates are not trivial
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * moved,
                                       err_msg=f"{top}.{k}")
    # head x10: the head's first-step moves are ten times the backbone's
    assert opt.adam.param_groups[0]["lr"] != opt.adam.param_groups[-1]["lr"]


def test_drop_path_and_dropout_keep_rates_scale_and_determinism():
    x = torch.ones(20_000, 3, 4)
    gen = lambda s: torch.Generator().manual_seed(s)
    y = drop_path(x, 0.3, True, gen(1))
    kept = y[:, 0, 0] != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert (y == y[:, :1, :1]).all()              # one draw per sample
    assert torch.equal(y, drop_path(x, 0.3, True, gen(1)))
    assert not torch.equal(y, drop_path(x, 0.3, True, gen(2)))
    assert drop_path(x, 0.3, False, gen(1)) is x
    assert drop_path(x, 0.0, True, gen(1)) is x
    dpr = [0.1 * i / 7 for i in range(8)]        # cascade_mit.py:350-354
    assert drop_path_rates(0.1, (2, 2, 2, 2)) == [dpr[0:2], dpr[2:4],
                                                  dpr[4:6], dpr[6:8]]

    head = SegformerHead(HEAD_IN, 2, 16, dropout_ratio=0.5)
    feats = [torch.randn(2, c, 8 // 2 ** i + 1, 8 // 2 ** i + 1,
                         generator=gen(3)) for i, c in enumerate(HEAD_IN)]
    a = head(feats, train=True, generator=gen(4))
    assert torch.equal(a, head(feats, train=True, generator=gen(4)))
    assert not torch.equal(a, head(feats, train=True, generator=gen(5)))
    assert torch.equal(head(feats), head(feats, train=False,
                                         generator=gen(5)))


def test_static_batches_match_jax():
    rng = np.random.default_rng(10)
    samples = [{"img": rng.random((8, 8, 3)), "gt_seg": rng.integers(
        0, 2, (8, 8)), "gt_det": rng.integers(0, 2, (8, 8))}
        for _ in range(7)]
    for shuffle, drop_last in ((False, False), (True, False), (True, True)):
        want = list(jds._batches_from(samples.__getitem__, 7, 3, shuffle, 4,
                                      drop_last))
        got = list(pds.batches_from(samples.__getitem__, 7, 3, shuffle, 4,
                                    drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


class _Blobs:
    """A few seeded 64² samples with `.batches` as SegTrainer takes them."""

    def __init__(self, n, seed):
        b = _batch(seed, n)
        self.samples = [{k: b[k][i] for k in ("img", "gt_seg", "gt_det")}
                        for i in range(n)]

    def batches(self, batch_size, shuffle=False, seed=0):
        return pds.batches_from(self.samples.__getitem__, len(self.samples),
                                batch_size, shuffle, seed, False)


def test_gt_guided_masks_feed_the_det_annotation_to_the_masks():
    """With `gt_guided_masks` the backbone builds its masks from gt_det
    (255, ignored, read as background); without it from its own det
    logits."""
    model = _port_model(det=True)
    seen = []
    real = model.backbone.forward
    model.backbone.forward = lambda x, det_gt=None, *a, **k: (
        seen.append(det_gt), real(x, det_gt, *a, **k))[1]
    batch = {k: torch.from_numpy(a) for k, a in _batch(13).items()}
    batch["gt_det"][1, :8] = 255
    for guided in (True, False):
        opt = pseg.make_seg_optimizer(model, 6e-5, total_iters=10)
        pseg.make_seg_train_step(model, opt, {"ce": 1.0},
                                 gt_guided_masks=guided)(batch)
    want = torch.where(batch["gt_det"] == 255, 0, batch["gt_det"])
    assert torch.equal(seen[0], want) and seen[1] is None


