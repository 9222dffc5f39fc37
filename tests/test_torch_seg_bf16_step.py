"""One seg train step with the models in bf16 (`dtype=torch.bfloat16` in
backbone and head; parameters, gradients and Adam state float32) against
the JAX package's bf16 and fp32 steps on the CPU: both recipes of
tests/test_torch_seg_train.py at its size (narrow segmentor, crop 64²,
batch 2, drop-path and dropout 0; the det step CE + Lovász + 0.1 det with
masks from the det logits, JAX's op by op, ROADMAP C10), the same
weights and batch.

Bars, those of tests/test_torch_sr_train.py::
test_bf16_train_step_matches_jax, on the gradients (captured before the
update) and the BatchNorm statistics' moves, per group, norm-relative:
`jaxs` is JAX's bf16 step's distance from JAX's fp32 step;

* the port's bf16 step is no further than 2 x jaxs from JAX's fp32 step
  and from JAX's bf16 step;
* bf16 really runs: at least jaxs / 8 from JAX's fp32 step (an fp32
  step sits at ~1e-6);
* groups: every gradient JAX's fp32 step does not hold at zero (norm
  over 1e-6 of the largest), the rest (the conv biases in front of a
  train-mode BatchNorm, whose exact gradient is 0: rounding moves them)
  no larger in norm than twice JAX's bf16 ones; the statistics' moves;
* the loss and its terms within 2e-2 relative of both JAX steps: they
  average bf16 logits (rounded 2^-8 relative at each of ~10 layers), and
  the det term's logits are large (the det classifier scaled x30 so that
  the fp32 text maps have clear margins). Measured: plain loss 2.1e-3 from
  JAX bf16; det loss 2.8e-3, its det term 1.0e-2 (JAX bf16 3.9e-3 from
  fp32).

The det step's text maps (soft-argmax of the bf16 det logits) may differ
between the packages where two bf16 logits nearly tie; the test prints
at how many pixels they do (measured: 7 of 512).

Measured (CPU, torch 2.13, jax 0.9; the port from JAX fp32, from JAX
bf16, then jaxs): plain gradients 0.209, 0.304, 0.277 (so few pixels at
batch 2 that bf16 moves train-mode BatchNorm gradients by tens of
percent, as in JAX); statistics 8.5e-3, 9.9e-3, 8.4e-3; det gradients
0.248, 0.256, 0.233; statistics 0.0168, 0.0205, 0.0192.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.core.mesh import make_mesh_for_batch
from fudanocr_tpu.models.seg import CascadeMiT as JaxCascadeMiT
from fudanocr_tpu.models.seg import CascadeMiTDetGuided as JaxDetGuided
from fudanocr_tpu.models.seg import DetGuidedEncoderDecoder as JaxDetSeg
from fudanocr_tpu.models.seg import EncoderDecoder as JaxSeg
from fudanocr_tpu.models.seg import SegformerHead as JaxSegformerHead
from fudanocr_tpu.train import seg as jseg
from fudanocr_tpu.train.state import TrainState
from fudanocr_tpu_torch.models.seg import (CascadeMiT, CascadeMiTDetGuided,
                                           DetGuidedEncoderDecoder,
                                           EncoderDecoder, SegformerHead)
from fudanocr_tpu_torch.models.seg.det_guided import soft_argmax
from fudanocr_tpu_torch.train import seg as pseg
from fudanocr_tpu_torch.utils.weights import (grad_state_dict,
                                              load_jax_variables,
                                              to_jax_variables)
from test_torch_seg_train import (HEAD_IN, NARROW, _batch, _capture_grads,
                                  _leaves, _randomize)
from torch_threads import one_torch_thread  # noqa: F401

LOSS_REL = 2e-2


def _jax_model(det: bool, dtype):
    head = JaxSegformerHead(2, 32, dropout_ratio=0.0, dtype=dtype)
    if det:
        return JaxDetSeg(backbone=JaxDetGuided(**NARROW, drop_path_rate=0.0,
                                               instance_impl="device",
                                               dtype=dtype),
                         decode_head=head)
    return JaxSeg(backbone=JaxCascadeMiT(**NARROW, drop_path_rate=0.0,
                                         dtype=dtype), decode_head=head)


def _port_model(det: bool):
    bf = torch.bfloat16
    backbone = (CascadeMiTDetGuided if det else CascadeMiT)(
        **NARROW, drop_path_rate=0.0, dtype=bf)
    head = SegformerHead(HEAD_IN, 2, 32, dropout_ratio=0.0, dtype=bf)
    return (DetGuidedEncoderDecoder if det else EncoderDecoder)(backbone,
                                                                head)


def _jax_step(det, dtype, v, batch, weights):
    jm = _jax_model(det, dtype)
    state = TrainState.create(v["params"], v["batch_stats"],
                              _capture_grads())
    step = jseg.make_seg_train_step(jm, make_mesh_for_batch(2), weights,
                                    det_loss_ratio=0.1, wrap_jit=False)
    if not det:
        step = jax.jit(step)
    new, metrics = step(state, {k: jnp.asarray(a) for k, a in batch.items()},
                        jax.random.PRNGKey(0))
    text = None
    if det:
        det_logits = jm.apply(v, jnp.asarray(batch["img"]), train=True,
                              mutable=["batch_stats"])[0][1]
        text = soft_argmax(torch.tensor(np.asarray(
            det_logits.astype(jnp.float32)))).numpy()
    return new, {k: float(a) for k, a in metrics.items()}, text


def _norm_rel(a, b, keys, base=None) -> float:
    base = base or {k: 0.0 for k in keys}
    num = sum(np.sum((a[k] - b[k]) ** 2) for k in keys)
    den = sum(np.sum((b[k] - base[k]) ** 2) for k in keys)
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("det", [False, True])
def test_bf16_train_step_matches_jax(det):
    porter = "segmentor_det" if det else "segmentor"
    weights = {"ce": 1.0, "lovasz": 1.0} if det else {"ce": 1.0}
    m = _port_model(det)
    v = _randomize(to_jax_variables(m, porter, **NARROW),
                   np.random.default_rng(21 + det))
    batch = _batch(5 + det)
    if not det:
        del batch["gt_det"]
        batch["valid"][1] = 0.0                 # a padded tail sample
    j16, want16, text16 = _jax_step(det, jnp.bfloat16, v, batch, weights)
    j32, want32, _ = _jax_step(det, None, v, batch, weights)

    load_jax_variables(m, porter, v, **NARROW)
    opt = pseg.make_seg_optimizer(m, 6e-5, total_iters=1000)
    seen = {}
    step_once = opt.step
    opt.step = lambda: (seen.update(
        grads=to_jax_variables(grad_state_dict(m), porter, **NARROW)),
        step_once())[1]
    pstep = pseg.make_seg_train_step(m, opt, weights, det_loss_ratio=0.1)
    got = pstep({k: torch.from_numpy(a) for k, a in batch.items()},
                torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in m.parameters())
    assert all(s["exp_avg"].dtype == torch.float32
               for s in opt.adam.state.values())

    assert set(got) == set(want16)
    for k in want16:
        g = got[k].item()
        print(f"{k}: port {g:.6f}, JAX bf16 {want16[k]:.6f}, JAX fp32 "
              f"{want32[k]:.6f}")
        if k != "acc":      # a count of argmax pixels, not a loss term
            np.testing.assert_allclose(g, want16[k], rtol=LOSS_REL,
                                       err_msg=k)
            np.testing.assert_allclose(g, want32[k], rtol=LOSS_REL,
                                       err_msg=k)
    if det:
        # the port's text map of this step's forward (train mode, the
        # start weights)
        mt = load_jax_variables(_port_model(True), porter, v, **NARROW)
        with torch.no_grad():
            text = soft_argmax(mt(torch.from_numpy(batch["img"]),
                                  train=True)[1]).numpy()
        print(f"det step: text maps differ from JAX bf16's at "
              f"{int((text != text16).sum())} of {text.size} pixels")

    gp = _leaves(seen["grads"]["params"])
    g16, g32 = _leaves(j16.opt_state), _leaves(j32.opt_state)
    top = max(np.linalg.norm(w) for w in g32.values())
    zero = [k for k in g32 if np.linalg.norm(g32[k]) <= 1e-6 * top]
    rest = [k for k in g32 if k not in zero]
    assert 0 < len(zero) < len(rest)
    ours, jaxs = _norm_rel(gp, g32, rest), _norm_rel(g16, g32, rest)
    to16 = _norm_rel(gp, g16, rest)
    print(f"gradients: port from fp32 {ours:.4g}, from JAX bf16 {to16:.4g}; "
          f"jaxs {jaxs:.4g}")
    assert jaxs / 8 <= ours <= 2 * jaxs and to16 <= 2 * jaxs
    n_ours = np.sqrt(sum(np.sum(gp[k] ** 2) for k in zero))
    n_jax = np.sqrt(sum(np.sum(g16[k] ** 2) for k in zero))
    print(f"zero-gradient biases: port norm {n_ours:.4g}, JAX bf16 "
          f"{n_jax:.4g} (largest gradient {top:.4g})")
    assert n_ours <= 2 * n_jax + 1e-6 * top

    start = _leaves(v["batch_stats"])
    sp = _leaves(to_jax_variables(m, porter, **NARROW)["batch_stats"])
    s16, s32 = _leaves(j16.batch_stats), _leaves(j32.batch_stats)
    keys = list(start)
    ours = _norm_rel(sp, s32, keys, start)
    jaxs = _norm_rel(s16, s32, keys, start)
    to16 = _norm_rel(sp, s16, keys, start)
    print(f"statistics: port from fp32 {ours:.4g}, from JAX bf16 "
          f"{to16:.4g}; jaxs {jaxs:.4g}")
    assert jaxs / 8 <= ours <= 2 * jaxs and to16 <= 2 * jaxs
