"""Text Gestalt's stroke-focus training in the port (data/codecs.py,
losses/stroke_focus.py, train/sr.py `StrokeSRTrainer`) against the JAX
package on the CPU, on the same seeded numpy inputs and weights, fp32:

* the stroke codec's encoding equals the JAX codec's (the built-in
  fallback table, and a table file);
* `StrokeFocusLoss` equals the JAX loss with the oracle's weights carried
  across, rel 1e-5;
* one TSRN stroke-focus train step equals the JAX step: the x100 loss rel
  1e-5, the BatchNorm statistics, and every parameter after the clip and
  Adam (lr = eps = 1, so the update holds the clipped gradient; see
  tests/test_torch_sr_train.py::test_train_step_matches_jax);
* `StrokeSRTrainer` trains a small TSRN on synthetic TextZoom with the
  HR-map cache and evaluates through the fused-GRU inference path.

TSRN has no dropout and the frozen oracle runs deterministic on both
sides, so nothing is patched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fudanocr_tpu.core.mesh import make_mesh_for_batch
from fudanocr_tpu.data.codecs import english_stroke_codec as jax_codec
from fudanocr_tpu.losses.stroke_focus import \
    StrokeFocusLoss as JaxStrokeFocusLoss
from fudanocr_tpu.models.rec.ocr_transformer import \
    OCRTransformer as JaxOCRTransformer
from fudanocr_tpu.models.sr import TSRN as JaxTSRN
from fudanocr_tpu.train.sr import make_sr_train_step as jax_train_step
from fudanocr_tpu.train.state import TrainState
from fudanocr_tpu_torch.data.codecs import english_stroke_codec
from fudanocr_tpu_torch.losses.stroke_focus import StrokeFocusLoss
from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
from fudanocr_tpu_torch.models.sr import TSRN
from fudanocr_tpu_torch.nn import recurrent
from fudanocr_tpu_torch.train.sr import StrokeSRTrainer, make_sr_train_step
from fudanocr_tpu_torch.train.state import AdamWithClip
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)
from torch_threads import one_torch_thread  # noqa: F401

# the stroke oracle at reduced width (the recipe's is (1, 2, 5, 3), 16
# heads, 512/1024/2048; chip_smoke.py phase 21 runs that one)
ORACLE = dict(vocab=10, num_in=1, layers=(1, 1, 1, 1), num_heads=4,
              d_embed=32, d_model=64, d_ff=64)
LABELS = ["gestalt", "Text42", "a", "stroke-focus!"]
MAX_LEN = 32


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def test_stroke_codec_matches_jax(tmp_path):
    for path in (None, tmp_path / "english_decomposition.txt"):
        if path is not None:
            path.write_text("a 12\nb 345\nT 9\n4 77\n")
            path = str(path)
        got = english_stroke_codec(path)
        want = jax_codec(path)
        assert got.num_classes == want.num_classes == 10
        for g, w in zip(got.encode(LABELS, MAX_LEN),
                        want.encode(LABELS, MAX_LEN)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.fixture(scope="module")
def oracle():
    om = JaxOCRTransformer(**ORACLE)
    ov = jax.tree_util.tree_map(np.asarray, om.init(
        jax.random.PRNGKey(2), jnp.zeros((2, 32, 128, 1)),
        jnp.zeros((2, 4), jnp.int32)))
    port = load_jax_variables(OCRTransformer(**ORACLE), "ocr_transformer",
                              ov, layers=ORACLE["layers"])
    return om, ov, port


@pytest.mark.parametrize("cached", [False, True])
def test_stroke_focus_loss_matches_jax(oracle, cached):
    om, ov, port = oracle
    rng = np.random.default_rng(0)
    hr = rng.random((4, 32, 128, 3)).astype(np.float32)
    sr = np.clip(hr + rng.standard_normal(hr.shape).astype(np.float32)
                 * 0.1, 0, 1).astype(np.float32)
    ti, tg, ln = english_stroke_codec(None).encode(LABELS, MAX_LEN)
    jfn = JaxStrokeFocusLoss(om, ov, stroke_lambda=50.0)
    pfn = StrokeFocusLoss(port, stroke_lambda=50.0)
    jargs = [jnp.asarray(a) for a in (sr, hr, ti, tg, ln)]
    targs = [torch.from_numpy(sr), torch.from_numpy(hr)] + [
        torch.from_numpy(a).long() for a in (ti, tg, ln)]
    jextra, textra = {}, {}
    if cached:
        jextra["hr_map"] = jfn.hr_oracle_map(jargs[1], jargs[2])
        textra["hr_map"] = pfn.hr_oracle_map(targs[1], targs[2])
        np.testing.assert_allclose(textra["hr_map"].numpy(),
                                   np.asarray(jextra["hr_map"]), rtol=1e-4,
                                   atol=1e-6)
    want, waux = jfn(*jargs, **jextra)
    got, gaux = pfn(*targs, **textra)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert gaux.keys() == waux.keys() == {"mse", "attention"}
    for k in gaux:
        np.testing.assert_allclose(gaux[k].item(), float(waux[k]),
                                   rtol=1e-5, err_msg=k)
    assert gaux["attention"].item() > 0


def _randomize(variables, rng):
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


def test_stroke_train_step_matches_jax(oracle):
    """One whole step of TSRN (2 SRBs, hidden 8, LR 16x64, B = 2) under
    the stroke-focus loss: the x100 loss and its terms, the BatchNorm
    statistics after it, and every parameter after the 0.25 clip and Adam
    with lr = eps = 1 (the update is g / (|g| + 1) ~ the clipped g),
    mapped back through the `tsrn` porter; each leaf to 2e-6 absolute
    (~0.5 % of a move), as the TBSRN step is held."""
    om, ov, port = oracle
    rng = np.random.default_rng(3)
    lr = rng.random((2, 16, 64, 3)).astype(np.float32)
    hr = rng.random((2, 32, 128, 3)).astype(np.float32)
    ti, tg, ln = english_stroke_codec(None).encode(LABELS[:2], MAX_LEN)
    jm = JaxTSRN(scale_factor=2, width=128, height=32, srb_nums=2,
                 hidden_units=8)
    v = _randomize(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(lr))), rng)
    tx = optax.chain(optax.clip_by_global_norm(0.25),
                     optax.adam(1.0, b1=0.5, b2=0.999, eps=1.0))
    state = TrainState.create(v["params"], v["batch_stats"], tx)
    step = jax.jit(jax_train_step(jm, JaxStrokeFocusLoss(om, ov),
                                  make_mesh_for_batch(2), wrap_jit=False))
    new_state, want = step(state, {
        "hr": jnp.asarray(hr), "lr": jnp.asarray(lr),
        "text_input": jnp.asarray(ti), "text_gt": jnp.asarray(tg),
        "lengths": jnp.asarray(ln)}, jax.random.PRNGKey(0))

    model = load_jax_variables(TSRN(srb_nums=2, hidden_units=8,
                                    fused_gru=True), "tsrn", v, srb_nums=2)
    opt = AdamWithClip(model.parameters(), lr=1.0, eps=1.0)
    pstep = make_sr_train_step(model, StrokeFocusLoss(port), opt)
    got = pstep({"hr": torch.from_numpy(hr), "lr": torch.from_numpy(lr),
                 **{k: torch.from_numpy(a).long() for k, a in
                    (("text_input", ti), ("text_gt", tg), ("lengths", ln))}})

    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    for k in ("mse", "attention"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert got["grad_norm"].item() > 0.25      # the clip bit
    back = to_jax_variables(model, "tsrn", srb_nums=2)
    for tree, want_tree, rtol, atol in (
            (back["batch_stats"], new_state.batch_stats, 1e-4, 1e-5),
            (back["params"], new_state.params, 0, 2e-6)):
        g, w = _leaves(tree), _leaves(want_tree)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=k)
    start = _leaves(v["params"])
    moved = max(np.abs(a - start[k]).max()
                for k, a in _leaves(new_state.params).items())
    assert moved > 1e-3


def test_stroke_trainer_on_synthetic_text_zoom(monkeypatch, oracle):
    """The port alone, as the JAX app runs it: stroke labels reach the
    loss, the HR-map cache fills in epoch 0 and serves epoch 1, the loss
    falls, and `evaluate()` runs TSRN's fused-GRU inference route (the
    twin on the CPU)."""
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom

    torch.manual_seed(0)
    model = TSRN(scale_factor=2, width=128, height=32, stn=True, srb_nums=1,
                 hidden_units=8, fused_gru=True)
    data = SyntheticTextZoom(num_samples=16, scale=2)
    trainer = StrokeSRTrainer(model, StrokeFocusLoss(oracle[2]), data, data,
                              batch_size=8, lr=1e-3, epochs=4,
                              eval_every=10 ** 9)
    batches, losses = [], []
    step = trainer.train_step

    def recording_step(batch, generator):
        batches.append(batch)
        out = step(batch, generator)
        losses.append(out["loss"].item())
        return out

    trainer.train_step = recording_step
    trainer.train()
    want = english_stroke_codec(None).encode(data.labels[:8], 32)
    for got, w in zip((batches[0][k] for k in ("text_input", "text_gt",
                                               "lengths")), want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert trainer.step == 8 and len(trainer._hr_map_cache) == 2
    assert batches[2]["hr_map"] is batches[0]["hr_map"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    calls = []
    real = recurrent.fused_bigru_x
    monkeypatch.setattr(recurrent, "fused_bigru_x",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    res = trainer.evaluate(trainer.step)
    assert res["psnr"] > 5.0 and 0.0 < res["ssim"] <= 1.0
    # gru1 of the one block: 8 images x 64 columns = 512 rows of 16 steps
    # of its 16 input features
    assert calls == [(512, 16, 16)] * 2
