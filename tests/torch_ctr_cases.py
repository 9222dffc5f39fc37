"""Shared pieces of the CTR parity tests (tests/test_torch_ctr_*.py): the
small model configurations (the JAX package's own smoke sizes:
tests/test_ctr_sld.py, test_ctr_variants.py, test_ccr_clip.py), random
JAX variables, and the decode-id check.

Decoded ids are held equal to JAX's until a row's first difference, and
there JAX's top-2 margin must lie within twice the measured distance of
the two packages' step outputs: a near tie may go either way."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)

SLD = dict(vocab=7, num_in=3, layers=(1, 1, 1, 1), num_heads=4, d_embed=32,
           d_model=64, d_ff=128, stage1_pool=False, encoder_width_div=8)
IDS = dict(vocab=38, out_dim=48, num_in=3, num_heads=4,
           encoder_preset="image_ids", encoder_width_div=8, d_embed=32,
           d_model=64, d_ff=128)
OICTR = dict(vocab=38, d_embed=32, d_model=64, encoder_layers=(1, 1, 1),
             encoder_width_div=8)
CLIP = dict(vocab_size=14, embed_dim=2048, context_length=8,
            transformer_width=32, transformer_heads=4, transformer_layers=2)
CLIP_VISION = (1, 1, 1, 1)


def randomize(variables, rng):
    """Random weights (fan-in scaled), BN statistics away from 0 / 1."""
    def leaf(path, a):
        key = getattr(path[-1], "key", None)
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
    return jax.tree_util.tree_map_with_path(
        leaf, jax.tree_util.tree_map(np.asarray, variables))


def init(module, *args, seed=0, **kw):
    """Randomised variables of a JAX module, numpy leaves."""
    v = jax.jit(module.init)(jax.random.PRNGKey(seed),
                             *map(jnp.asarray, args), **kw)
    return randomize(v, np.random.default_rng(seed))


def small_clip_vision(monkeypatch):
    """Build the JAX CCRCLIP's image tower with CLIP_VISION blocks (the
    JAX module fixes (3, 4, 6, 3))."""
    from fudanocr_tpu.models.rec import ccr_clip as jccr

    monkeypatch.setattr(jccr, "CLIPResNet50", functools.partial(
        jccr.CLIPResNet50, layers=CLIP_VISION))


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def check_ids(got, want, got_scores, want_scores):
    """got/want (B, T) ids; *_scores (B, T, V): each package's step
    outputs on the token buffer JAX decoded (what JAX's argmax read)."""
    got, want = np.asarray(got), np.asarray(want)
    got_scores = np.asarray(got_scores, np.float64)
    want_scores = np.asarray(want_scores, np.float64)
    err = np.abs(got_scores - want_scores).max()
    assert got.shape == want.shape
    ties = 0
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size == 0:
            continue
        top2 = np.sort(want_scores[b, diff[0]])[-2:]
        assert top2[1] - top2[0] <= 2 * err, (b, diff[0], top2, err)
        ties += 1
    return err, ties


def capture_grads_tx():
    """An optax transformation whose update is zero and whose state is the
    last gradient: a JAX train step through it returns its gradients in
    `opt_state`, exactly, and leaves the parameters as they were."""
    import optax

    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        lambda params: zeros(params),
        lambda grads, state, params=None: (zeros(grads), grads))


def no_update(model):
    """The port's counterpart: an optimizer that leaves the parameters
    (and their .grad) as they are."""
    import torch

    from fudanocr_tpu_torch.train.state import ScheduledOptimizer

    return ScheduledOptimizer(torch.optim.SGD(model.parameters(), lr=0.0),
                              lambda count: 0.0)


def no_port_dropout(model):
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    return model


def check_step(model, porter, state, loss, want_loss, porter_kw=None,
               grad_rel=1e-3, hold=None):
    """The training bar: loss within 1e-5 relative, each parameter's
    gradient within `grad_rel` norm-relative (plus 1e-6 of the largest
    gradient's norm, for the exactly-zero gradients of biases in front of
    a train-mode BatchNorm, which hold rounding noise), BatchNorm
    statistics within 1e-5. `state` is the JAX TrainState after a
    `capture_grads_tx` step. `hold(key)`, where given, picks the gradient
    leaves held to the bar (the JAX tree's key strings). Returns the
    largest held gradient distance."""
    from fudanocr_tpu_torch.utils.weights import (grad_state_dict,
                                                  to_jax_variables)

    kw = porter_kw or {}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    back = to_jax_variables(grad_state_dict(model), porter, **kw)
    got, want = leaves(back["params"]), leaves(state.opt_state)
    assert got.keys() == want.keys()
    top = max(np.linalg.norm(w) for w in want.values())
    worst = 0.0
    held = [k for k in want if hold is None or hold(k)]
    assert held
    for k in held:
        w = want[k]
        d = np.linalg.norm(got[k].astype(np.float64) - w)
        assert d <= grad_rel * np.linalg.norm(w) + 1e-6 * top, (
            k, d, np.linalg.norm(w))
        worst = max(worst, norm_rel(got[k], w) if np.linalg.norm(w) > 1e-6
                    * top else 0.0)
    gs, ws = leaves(back["batch_stats"]), leaves(state.batch_stats)
    assert gs.keys() == ws.keys()
    for k, w in ws.items():
        np.testing.assert_allclose(gs[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    return worst
