"""TBSRN text-focus training in the port (train/sr.py, train/state.py,
nn/tps.py, the train modes of nn/stn.py and models/sr/tbsrn.py) against the
JAX package on the CPU, on the same seeded numpy inputs and weights, in
fp32 and, for the whole step, also in bf16 (the JAX package's benched
training configuration).

Dropout cannot be matched across the packages on the CPU (the JAX train
path takes flax's threefry dropout there, not the hash kernel), so the
parity tests turn it off on both sides: flax `Dropout` returns its input
(patched here, nothing in the package changes) and the port's rates are
0. The hash dropout itself is held against JAX bit for bit in
tests/test_torch_flash_attention.py."""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fudanocr_tpu.core.mesh import make_mesh_for_batch
from fudanocr_tpu.losses.sr_losses import TextFocusLoss as JaxTextFocusLoss
from fudanocr_tpu.models.rec.ocr_transformer import \
    OCRTransformer as JaxOCRTransformer
from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN
from fudanocr_tpu.nn import layers as jl
from fudanocr_tpu.nn.stn import STNHead as JaxSTNHead
from fudanocr_tpu.nn.tps import TPSSpatialTransformer as JaxTPS
from fudanocr_tpu.train.sr import make_sr_train_step as jax_train_step
from fudanocr_tpu.train.state import TrainState
from fudanocr_tpu.train.state import adam_with_clip as jax_adam_with_clip
from fudanocr_tpu.utils import torch_port
from fudanocr_tpu_torch.losses.sr_losses import (TextFocusLoss,
                                                 encode_text_labels)
from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
from fudanocr_tpu_torch.models.sr import TBSRN
from fudanocr_tpu_torch.nn import layers as pl
from fudanocr_tpu_torch.nn.stn import STNHead
from fudanocr_tpu_torch.nn.tps import TPSSpatialTransformer
from fudanocr_tpu_torch.train.sr import SRTrainer, make_sr_train_step
from fudanocr_tpu_torch.train.state import AdamWithClip, adam_with_clip
from fudanocr_tpu_torch.utils import porters
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)
ORACLE = dict(vocab=37, num_in=1, layers=(1, 1, 1, 1), num_heads=4,
              d_embed=32, d_model=64, d_ff=64)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _no_port_dropout(model):
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    return model


def _randomize(variables, rng):
    """Non-trivial BN statistics and LN/BN scales (inits are 0 / 1)."""
    def leaf(path, a):
        key = path[-1].key
        if key == "var":
            return (rng.random(a.shape) * 0.5 + 0.75).astype(np.float32)
        if key in ("mean", "bias") and a.ndim == 1:
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if key == "scale":
            return (1 + rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, rtol, atol):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_batch_norm_train_mode_follows_flax():
    """Biased batch variance in the normalisation AND in the running
    update (torch's own BatchNorm2d updates with the unbiased one)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5, 6, 3)).astype(np.float32) * 2 + 1
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    m = torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        m.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        m.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        m.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    got = pl.batch_norm(m, _nchw(x), train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    for k, t in (("mean", m.running_mean), ("var", m.running_var)):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)


def test_tps_matches_jax():
    """Warp, sampling coordinates, and the gradients in the control points
    and the image (grid_sample vs the JAX gather build). The two packages
    round the sampling coordinates differently by ~1e-6 of the image
    width; times pixel steps of up to 1 that moves samples by ~1e-4, so
    the warp is held to the module bar."""
    rng = np.random.default_rng(1)
    img = rng.random((2, 16, 64, 3)).astype(np.float32)
    xs = np.linspace(0.01, 0.99, 10)
    ctrl = np.concatenate([np.stack([xs, np.full(10, 0.05)], 1),
                           np.stack([xs, np.full(10, 0.95)], 1)])
    ctrl = ctrl[None].repeat(2, 0)
    ctrl = (ctrl + rng.standard_normal(ctrl.shape) * 0.03).astype(np.float32)
    jm = JaxTPS(output_size=(16, 64))
    w = rng.standard_normal((2, 16, 64, 3)).astype(np.float32)

    def jloss(im, c):
        return jnp.sum(jm.apply({}, im, c)[0] * w)

    (want, want_src) = jm.apply({}, jnp.asarray(img), jnp.asarray(ctrl))
    want_gi, want_gc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img),
                                                       jnp.asarray(ctrl))
    m = TPSSpatialTransformer((16, 64))
    ti = torch.from_numpy(img).requires_grad_()
    tc = torch.from_numpy(ctrl).requires_grad_()
    got, src = m(ti, tc)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(src.detach().numpy(), np.asarray(want_src),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_gi),
                               rtol=0, atol=ATOL * 10)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want_gc),
                               rtol=1e-3, atol=1e-2)
    assert not dict(m.state_dict())   # constants stay out of checkpoints


class _Holder(torch.nn.Module):
    def __init__(self, name, module):
        super().__init__()
        self.add_module(name, module)


def test_stn_head_train_mode_matches_jax(monkeypatch):
    """Batch statistics in the conv stack and stn_fc1, and the running
    statistics after the step."""
    monkeypatch.setitem(porters.PORTERS, "_stn", lambda sd: dict(
        zip(("params", "batch_stats"), porters._stn_head(sd))))
    rng = np.random.default_rng(2)
    x = rng.random((4, 16, 64, 3)).astype(np.float32)
    jm = JaxSTNHead(num_ctrlpoints=20)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    v["params"]["fc2"]["kernel"] = (
        rng.standard_normal((512, 40)) * 0.05).astype(np.float32)
    (want_feat, want_pts), upd = jm.apply(v, jnp.asarray(x), train=True,
                                          mutable=["batch_stats"])
    holder = load_jax_variables(_Holder("stn_head", STNHead(3, 20)), "_stn",
                                v)
    with torch.no_grad():
        feat, pts = holder.stn_head(_nchw(x), train=True)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat),
                               rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(pts.numpy(), np.asarray(want_pts),
                               rtol=1e-4, atol=ATOL)
    _, got_stats = torch_port._stn_head(holder.state_dict())
    _assert_trees_close(got_stats, upd["batch_stats"], 1e-4, 1e-5)


@pytest.fixture(scope="module")
def step_setup():
    """JAX TBSRN (2 SRBs, STN on, LR 16x64, B = 2) and the small oracle,
    both with random weights, plus one batch."""
    rng = np.random.default_rng(3)
    lr = rng.random((2, 16, 64, 3)).astype(np.float32)
    hr = rng.random((2, 32, 128, 3)).astype(np.float32)
    labels = ["tbsrn", "Text42"]
    jm = JaxTBSRN(scale_factor=2, width=128, height=32, stn=True, srb_nums=2,
                  hidden_units=32, wide_out_block=0)
    v = _randomize(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(lr))), rng)
    v["params"]["stn_head"]["fc2"]["kernel"] = (
        rng.standard_normal((512, 40)) * 1e-3).astype(np.float32)
    om = JaxOCRTransformer(**ORACLE)
    ov = jax.tree_util.tree_map(np.asarray, om.init(
        jax.random.PRNGKey(2), jnp.zeros((2, 32, 128, 1)),
        jnp.zeros((2, 4), jnp.int32)))
    return jm, v, om, ov, (hr, lr, labels)


def _port_models(v, ov):
    model = _no_port_dropout(load_jax_variables(TBSRN(srb_nums=2), "tbsrn",
                                                v, srb_nums=2))
    oracle = load_jax_variables(OCRTransformer(**ORACLE), "ocr_transformer",
                                ov, layers=ORACLE["layers"])
    return model, oracle


def test_train_step_matches_jax(step_setup, no_dropout):
    """One whole train step: the x100 loss and its terms, the BatchNorm
    statistics after it, and every parameter after the 0.25 clip and
    Adam, mapped back through the JAX package's `tbsrn` porter.

    Adam runs here with lr = eps = 1 on both sides, so its first update is
    g / (|g| + 1) ~ g and the parameters after it hold the clipped
    gradients to ~1e-6. (With the recipe's eps = 1e-8 the first update is
    lr * sign(g), which says little about g, and amplifies the rounding
    noise of the exactly-zero gradients of the conv biases in front of a
    train-mode BatchNorm to +-lr.) The recipe's optimizer is held against
    optax in test_adam_with_clip_matches_optax."""
    jm, v, om, ov, (hr, lr, labels) = step_setup
    ti, tg, ln = encode_text_labels(labels, 32)
    jfn = JaxTextFocusLoss(om, ov)
    tx = optax.chain(optax.clip_by_global_norm(0.25),
                     optax.adam(1.0, b1=0.5, b2=0.999, eps=1.0))
    state = TrainState.create(v["params"], v["batch_stats"], tx)
    step = jax.jit(jax_train_step(jm, jfn, make_mesh_for_batch(2),
                                  wrap_jit=False))
    jbatch = {"hr": jnp.asarray(hr), "lr": jnp.asarray(lr),
              "text_input": jnp.asarray(ti), "text_gt": jnp.asarray(tg),
              "lengths": jnp.asarray(ln)}
    new_state, want = step(state, jbatch, jax.random.PRNGKey(0))

    model, oracle = _port_models(v, ov)
    opt = AdamWithClip(model.parameters(), lr=1.0, eps=1.0)
    pstep = make_sr_train_step(model, TextFocusLoss(oracle), opt)
    batch = {"hr": torch.from_numpy(hr), "lr": torch.from_numpy(lr),
             **{k: torch.from_numpy(a).long() for k, a in
                (("text_input", ti), ("text_gt", tg), ("lengths", ln))}}
    got = pstep(batch, torch.Generator().manual_seed(0))

    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    for k in ("mse", "attention", "recognition"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-8, err_msg=k)
    assert got["grad_norm"].item() > 0.25      # the clip bit
    back = to_jax_variables(model, "tbsrn", srb_nums=2)
    _assert_trees_close(back["batch_stats"], new_state.batch_stats, 1e-4,
                        1e-5)
    got_p, want_p = _leaves(back["params"]), _leaves(new_state.params)
    start = _leaves(v["params"])
    assert got_p.keys() == want_p.keys()
    assert np.abs(want_p["['stn_head']['conv0']['Conv_0']['kernel']"]
                  - start["['stn_head']['conv0']['Conv_0']['kernel']"]
                  ).max() > 1e-4            # the gradient reached the STN
    for k, want_k in want_p.items():
        moved = np.abs(want_k - start[k]).max()
        # the STN's gradient is a sum over every sampled pixel of the TPS
        # warp whose terms largely cancel (fc2's bias gets ~2e-3 out of
        # per-pixel terms of ~1e-1): its leaves are held to 2 % of their
        # move; every other leaf to 2e-6 absolute (~0.5 % of a move)
        tol = 2e-6 + (0.02 * moved if k.startswith("['stn_head']") else 0)
        np.testing.assert_allclose(got_p[k], want_k, rtol=0, atol=tol,
                                   err_msg=k)


def _jax_step(jm, om, ov, v, batch):
    """(state after, metrics) of one jitted JAX train step from v with
    Adam at lr = eps = 1 (see test_train_step_matches_jax)."""
    tx = optax.chain(optax.clip_by_global_norm(0.25),
                     optax.adam(1.0, b1=0.5, b2=0.999, eps=1.0))
    state = TrainState.create(v["params"], v["batch_stats"], tx)
    step = jax.jit(jax_train_step(jm, JaxTextFocusLoss(om, ov),
                                  make_mesh_for_batch(2), wrap_jit=False))
    return step(state, batch, jax.random.PRNGKey(0))


def _norm_rel(got, want, start, keys) -> float:
    """Norm-relative distance of the moves got - start and want - start
    over the leaves `keys`."""
    g = np.concatenate([(got[k] - start[k]).ravel() for k in keys])
    w = np.concatenate([(want[k] - start[k]).ravel() for k in keys])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_bf16_train_step_matches_jax(step_setup, no_dropout):
    """The same step with TBSRN and the oracle in bf16 on both sides, the
    JAX package's benched training configuration (bench_train.py:36-50)
    at the test's size: the port's bf16 step against JAX's bf16 step and,
    as the yardstick of what bf16 itself moves, JAX's fp32 step.

    The packages round to bf16 at other places (XLA:CPU and torch's CPU
    convolutions, the attention's probabilities), so their bf16 SR outputs
    differ by ~1-3e-2 norm-relative, as much as either differs from fp32;
    that is rounding, not a fault. Bars, with their reasons:
    * the x100 loss and its terms: 5e-3 relative to JAX's bf16 step (they
      average the SR output; measured 7e-5 to 1.4e-3);
    * the moves of the parameters (Adam at lr = eps = 1 holds the clipped
      gradients, see test_train_step_matches_jax) and the BatchNorm
      statistics after the step, per group, norm-relative: to JAX's fp32
      step and to JAX's bf16 step, no more than twice JAX's own bf16
      step's distance from fp32 ("jaxs"). Groups: the trunk (every leaf
      outside the STN but the conv biases in front of a train-mode
      BatchNorm), the STN, those biases (their exact gradient is 0: what
      moves them is rounding), the statistics;
    * bf16 really runs: the trunk's and the statistics' distance from
      JAX's fp32 step is at least jaxs / 8 (an fp32 step sits at ~1e-6).
      Measured (CPU, torch 2.13, jax 0.9): trunk 8.8e-3 from fp32 and
      2.7e-2 from JAX's bf16, jaxs 2.8e-2 (XLA:CPU rounds more of its bf16
      step than torch's CPU kernels do); statistics 1.8e-3 and 1.9e-3,
      jaxs 1.2e-3."""
    jm, v, om, ov, (hr, lr, labels) = step_setup
    ti, tg, ln = encode_text_labels(labels, 32)
    jbatch = {"hr": jnp.asarray(hr), "lr": jnp.asarray(lr),
              "text_input": jnp.asarray(ti), "text_gt": jnp.asarray(tg),
              "lengths": jnp.asarray(ln)}
    kw = dict(scale_factor=2, width=128, height=32, stn=True, srb_nums=2,
              hidden_units=32, wide_out_block=0)
    jbf, want = _jax_step(JaxTBSRN(**kw, dtype=jnp.bfloat16),
                          JaxOCRTransformer(**ORACLE, dtype=jnp.bfloat16),
                          ov, v, jbatch)
    j32, _ = _jax_step(jm, om, ov, v, jbatch)

    model = _no_port_dropout(load_jax_variables(
        TBSRN(srb_nums=2, dtype=torch.bfloat16), "tbsrn", v, srb_nums=2))
    oracle = load_jax_variables(
        OCRTransformer(**ORACLE, dtype=torch.bfloat16), "ocr_transformer",
        ov, layers=ORACLE["layers"])
    opt = AdamWithClip(model.parameters(), lr=1.0, eps=1.0)
    pstep = make_sr_train_step(model, TextFocusLoss(oracle), opt)
    batch = {"hr": torch.from_numpy(hr), "lr": torch.from_numpy(lr),
             **{k: torch.from_numpy(a).long() for k, a in
                (("text_input", ti), ("text_gt", tg), ("lengths", ln))}}
    got = pstep(batch, torch.Generator().manual_seed(0))
    for k in ("loss", "mse", "attention", "recognition"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=5e-3,
                                   err_msg=k)
    assert got["grad_norm"].item() > 0.25      # the clip bit

    back = to_jax_variables(model, "tbsrn", srb_nums=2)
    start = _leaves(v["params"])
    got_p, bf_p, fp_p = (_leaves(t) for t in (back["params"], jbf.params,
                                              j32.params))
    zero = [k for k in start if k.endswith("['bias']") and any(
        n in k for n in ("['conv1']", "['conv2']", "['trunk_tail']",
                         "['Conv_0']"))]
    stn = [k for k in start if k.startswith("['stn_head']")
           and k not in zero]
    trunk = [k for k in start if k not in zero and k not in stn]
    for name, keys in (("trunk", trunk), ("stn", stn), ("zero", zero)):
        ours = _norm_rel(got_p, fp_p, start, keys)
        jaxs = _norm_rel(bf_p, fp_p, start, keys)
        assert ours <= 2 * jaxs, (name, ours, jaxs)
        assert _norm_rel(got_p, bf_p, start, keys) <= 2 * jaxs, name
        if name == "trunk":
            assert ours >= jaxs / 8, (name, ours, jaxs)
    stats0 = {k: np.zeros_like(a) for k, a in
              _leaves(v["batch_stats"]).items()}
    got_s, bf_s, fp_s = (_leaves(t) for t in (back["batch_stats"],
                                              jbf.batch_stats,
                                              j32.batch_stats))
    ours = _norm_rel(got_s, fp_s, stats0, list(stats0))
    jaxs = _norm_rel(bf_s, fp_s, stats0, list(stats0))
    assert jaxs / 8 <= ours <= 2 * jaxs, ("batch_stats", ours, jaxs)
    assert _norm_rel(got_s, bf_s, stats0, list(stats0)) <= 2 * jaxs


@pytest.mark.parametrize("clip_bites", [False, True])
def test_adam_with_clip_matches_optax(clip_bites):
    rng = np.random.default_rng(4)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,))]
    scale = 1.0 if clip_bites else 1e-3
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * scale
              for p in params] for _ in range(3)]
    tx = jax_adam_with_clip(1e-2)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = adam_with_clip(tp, 1e-2)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for t, a in zip(tp, g):
            t.grad = torch.from_numpy(a.copy())
        norm = opt.step()
        assert (norm.item() >= 0.25) == clip_bites
    for t, a in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-7)


def test_three_epochs_on_synthetic_text_zoom(tmp_path):
    """The port alone, as tests/test_sr_train_smoke.py runs the JAX
    trainer: the loss falls over 3 epochs (dropout on), the HR-map cache
    fills in epoch 0 and serves epochs 1-2, evaluation scores the SR
    output (also over difficulty buckets), and the best checkpoint saves
    and resumes."""
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom

    torch.manual_seed(0)
    model = TBSRN(scale_factor=2, width=128, height=32, stn=True, srb_nums=1)
    oracle = OCRTransformer(**ORACLE)
    data = SyntheticTextZoom(num_samples=16, scale=2)
    trainer = SRTrainer(model, TextFocusLoss(oracle), data, data,
                        batch_size=8, lr=1e-3, epochs=3,
                        eval_every=10 ** 9, ckpt_dir=str(tmp_path))
    losses, maps = [], []
    step = trainer.train_step

    def recording_step(batch, generator):
        maps.append(batch["hr_map"])
        out = step(batch, generator)
        losses.append(out["loss"].item())
        return out

    trainer.train_step = recording_step
    trainer.train()
    assert trainer.step == 6 and len(trainer._hr_map_cache) == 2
    assert maps[2] is maps[0] and maps[5] is maps[1]   # cache hits
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, losses
    res = trainer.evaluate(trainer.step)
    assert res["psnr"] > 5.0 and 0.0 < res["ssim"] <= 1.0
    assert trainer.history[-1]["iter"] == 6
    trainer.eval_data = {"easy": data, "hard": data}    # difficulty buckets
    buckets = trainer.evaluate(7)
    assert buckets["easy_psnr"] == buckets["hard_psnr"] == res["psnr"]
    assert buckets["acc"] == 2 * res["psnr"]   # no recognizer: PSNR sums
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    trainer.resume(str(tmp_path / "best.pt"))
    for k, t in model.state_dict().items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
