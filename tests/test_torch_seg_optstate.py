"""The seg optimizer's state across the two packages on the CPU
(`SegAdam.jax_opt_state` / `load_jax_opt_state`, train/state.py, and
SegTrainer's periodic checkpoints, train/seg.py), on a narrow CascadeMiT
segmentor and JAX's `make_seg_optimizer` run through `tx.init` and
`tx.update` (not the jitted trainer step), with gradients drawn from a
numpy seed:

* JAX's state after two updates, taken into `SegAdam`, gives after a
  third update in both the parameters within rel 1e-5 of JAX's; and the
  reverse: the port's state after two updates, taken into optax;
* the port's `iter_N/state.msgpack` loads through JAX's
  `SegTrainer.resume` (its template: params, batch_stats, opt_state) and
  holds the port's state; a directory JAX wrote resumes the port's
  trainer.

The counts start at 1500, the end of the warmup, at a base lr of 1e-2,
so that each update moves every parameter well past rounding: moments
swapped, or parameters mapped by their position in a group, fail the
bar.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser

from fudanocr_tpu.core import checkpoint as jckpt
from fudanocr_tpu.train import seg as jseg
from fudanocr_tpu.train.state import TrainState
from fudanocr_tpu_torch.models.seg import (CascadeMiT, EncoderDecoder,
                                           SegformerHead)
from fudanocr_tpu_torch.train import seg as pseg
from fudanocr_tpu_torch.utils.weights import (export_state_dict,
                                              jax_variables,
                                              load_jax_variables)
from torch_ctr_cases import randomize
from torch_threads import one_torch_thread  # noqa: F401

SEG = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
           sr_ratios=(8, 4, 2, 1))
LR, START, TOTAL = 1e-2, 1500, 160_000
REL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """(port model factory, JAX variables, the JAX optimizer, three seeded
    gradient trees)."""
    def model():
        return EncoderDecoder(CascadeMiT(**SEG),
                              SegformerHead([8, 16, 40, 64], 2, 32))

    v = randomize(jax_variables(model()), np.random.default_rng(0))
    tx = jseg.make_seg_optimizer(v["params"], LR, total_iters=TOTAL)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        v["params"]) for _ in range(3)]
    return model, v, tx, grads


def _at_start(state):
    """optax's state with every count at START."""
    is_count = lambda s: isinstance(s, (optax.ScaleByAdamState,
                                        optax.ScaleByScheduleState))
    return jax.tree_util.tree_map(
        lambda s: s._replace(count=jnp.asarray(START, jnp.int32))
        if is_count(s) else s, state, is_leaf=is_count)


@functools.lru_cache(maxsize=None)
def _jitted_update(tx):
    @jax.jit
    def update(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    return update


def _jax_updates(tx, params, state, grads):
    update = _jitted_update(tx)
    for g in grads:
        params, state = update(g, state, params)
    return params, state


def _port_update(model, opt, grad_tree, batch_stats):
    """One `SegAdam` step with the gradients of `grad_tree` (JAX layout)
    set by parameter name."""
    template = {k: t.detach() for k, t in model.state_dict().items()}
    g = export_state_dict("segmentor", {"params": grad_tree,
                                        "batch_stats": batch_stats},
                          template, **SEG)
    for name, p in model.named_parameters():
        p.grad = g[name].clone()
    opt.step()


def _assert_params_close(got, want):
    got = jax.tree_util.tree_leaves_with_path(got)
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(got) == len(want)
    for path, g in got:
        w = np.asarray(want[path], np.float64)
        err = np.linalg.norm(np.asarray(g, np.float64) - w)
        assert err <= REL * np.linalg.norm(w), (jax.tree_util.keystr(path),
                                                err)


def _port(setup, variables):
    model_fn, v, _, _ = setup
    m = load_jax_variables(model_fn(), "segmentor", variables, **SEG)
    return m, pseg.make_seg_optimizer(m, LR, total_iters=TOTAL)


def test_jax_state_resumes_in_the_port(setup):
    _, v, tx, grads = setup
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    params, state = _jax_updates(tx, params, _at_start(tx.init(params)),
                                 grads[:2])
    want, _ = _jax_updates(tx, params, state, grads[2:])

    m, opt = _port(setup, {"params": params,
                           "batch_stats": v["batch_stats"]})
    opt.load_jax_opt_state(m, fser.to_state_dict(state), v["batch_stats"])
    assert opt.count == START + 2
    _port_update(m, opt, grads[2], v["batch_stats"])
    _assert_params_close(jax_variables(m)["params"], want)


def test_port_state_resumes_in_jax(setup):
    _, v, tx, grads = setup
    m, opt = _port(setup, v)
    start = fser.to_state_dict(_at_start(tx.init(v["params"])))
    opt.load_jax_opt_state(m, start, v["batch_stats"])
    for g in grads[:2]:
        _port_update(m, opt, g, v["batch_stats"])
    state = fser.from_state_dict(tx.init(v["params"]),
                                 opt.jax_opt_state(m))
    params = jax.tree_util.tree_map(jnp.asarray, jax_variables(m)["params"])
    want, _ = _jax_updates(tx, params, state, grads[2:])
    _port_update(m, opt, grads[2], v["batch_stats"])
    _assert_params_close(jax_variables(m)["params"], want)


def test_iter_checkpoints_cross_both_ways(setup, tmp_path):
    """The port's iter_N/ in JAX's `SegTrainer.resume` (run on a stand-in
    trainer holding only the TrainState it reads), and JAX's iter_N/ in
    the port's `SegTrainer.resume`."""
    model_fn, v, tx, grads = setup
    m, _ = _port(setup, v)
    trainer = pseg.SegTrainer(m, None, None, lr=LR, total_iters=TOTAL,
                              ckpt_dir=str(tmp_path / "port"))
    start = fser.to_state_dict(_at_start(tx.init(v["params"])))
    trainer.optimizer.load_jax_opt_state(m, start, v["batch_stats"])
    for g in grads[:2]:
        _port_update(m, trainer.optimizer, g, v["batch_stats"])
    trainer._save_periodic(START + 2)

    jt = types.SimpleNamespace(state=TrainState.create(
        v["params"], v["batch_stats"], tx))
    jseg.SegTrainer.resume(jt, str(tmp_path / "port" / f"iter_{START + 2}"))
    assert jt.start_iter == START + 2 and int(jt.state.step) == START + 2
    want = trainer._jax_tree(opt_state=True)
    got = {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
           "opt_state": fser.to_state_dict(jt.state.opt_state)}
    for k in want:
        for path, w in jax.tree_util.tree_leaves_with_path(want[k]):
            g = dict(jax.tree_util.tree_leaves_with_path(got[k]))[path]
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=jax.tree_util.keystr(path))

    jckpt.save(str(tmp_path / "jax" / "iter_9"),
               {"params": jt.state.params,
                "batch_stats": jt.state.batch_stats,
                "opt_state": jt.state.opt_state},
               meta={"step": 9, "best": 0.5})
    fresh = pseg.SegTrainer(model_fn(), None, None, lr=LR,
                            total_iters=TOTAL, auto_resume=True,
                            ckpt_dir=str(tmp_path / "jax"))
    assert fresh.start_iter == 9 and fresh.best == 0.5
    assert fresh.optimizer.count == START + 2
    for name, t in trainer.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(fresh.model.state_dict()[name], t), name
    params = dict(m.named_parameters())
    got_params = dict(fresh.model.named_parameters())
    for name, p in params.items():
        a, b = trainer.optimizer.adam.state[p], \
            fresh.optimizer.adam.state[got_params[name]]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key]), (name, key)


def test_optimizer_state_that_jax_cannot_hold_is_refused(setup):
    _, v, tx, _ = setup
    m, opt = _port(setup, v)
    state = fser.to_state_dict(_at_start(tx.init(v["params"])))
    state["inner_states"]["head"]["inner_state"]["2"]["count"] = np.asarray(
        3, np.int32)
    with pytest.raises(ValueError, match="counts disagree"):
        opt.load_jax_opt_state(m, state, v["batch_stats"])
    layer_decay = pseg.make_layer_decay_optimizer(m, num_layers=(1, 1, 1, 1))
    with pytest.raises(NotImplementedError):
        layer_decay.jax_opt_state(m)
