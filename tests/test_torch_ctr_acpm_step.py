"""ACPM's training step (apps/acpm/train.py `make_acpm_train_step`)
against the JAX package's (`ACPMTrainer._make_train_step`) on the CPU, as
tests/torch_ctr_step_cases.py holds the other CTR steps: the same seeded
batch (the port's print templates on both sides) and random weights
(tests/test_torch_ctr_acpm.py's models), dropout off on both sides; the JAX
step through an optax transformation that returns its gradients, the
port's through an optimizer that moves nothing; the training bar of
`torch_ctr_cases.check_step`.

Every gradient and BN statistic in float64; in float32 the loss, the
statistics and the gradients outside the encoder (ROADMAP C30). Both
`pretrain` settings: the templates' memory must be encoded with the
statistics from before the step (the feature loss reads it), and the
stroke-length target keeps the gradient of the predicted sums (pretrain
False)."""

import types

import jax
import pytest
import torch

from fudanocr_tpu.apps.acpm.train import ACPMTrainer as JaxTrainer
from fudanocr_tpu_torch.apps.acpm import train as app
from test_torch_ctr_acpm import _host_batch, _pair
from torch_ctr_cases import check_step, no_port_dropout, no_update
from torch_ctr_step_cases import _cast, _jax_step, no_dropout  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def acpm_step(x64, pretrain, rn_loss, stn, hold=None):
    """One ACPM step of each package from the same weights and batch,
    dropout off; the port's held to the training bar
    (`torch_ctr_cases.check_step`)."""
    jm, v, m = _pair("resnet", stn, rn_loss,
                     torch.float64 if x64 else torch.float32)
    m = no_port_dropout(m)
    host = {k: _cast(a, x64) for k, a in _host_batch(20).items()}
    cfg = types.SimpleNamespace(rn_loss=rn_loss, pretrain=pretrain)
    step = JaxTrainer._make_train_step(
        types.SimpleNamespace(model=jm, cfg=cfg))
    state, want = _jax_step(step.__wrapped__, v, host,
                            jax.random.PRNGKey(0), x64=x64)
    got = app.make_acpm_train_step(m, no_update(m), rn_loss, pretrain)(
        {k: torch.from_numpy(a) for k, a in host.items()})
    worst = check_step(m, "acpm", state, got, want, hold=hold)
    print(f"acpm step (pretrain {pretrain}, {rn_loss}, stn {stn}): loss "
          f"{float(got)} vs {float(want)}, worst grad rel {worst:.2e}")


def _outside_encoder(key):
    return not key.startswith("['encoder']")


STEP_CASES = [(False, "L1", False), (True, "CE", True)]


@pytest.mark.parametrize("pretrain,rn_loss,stn", STEP_CASES)
def test_acpm_step_matches_jax_float64(no_dropout, pretrain, rn_loss, stn):
    """float64 on both sides, with the STN and the CE radical counter in
    the pretrain case."""
    acpm_step(True, pretrain, rn_loss, stn)


@pytest.mark.parametrize("pretrain,rn_loss", [(False, "L1"), (True, "CE")])
def test_acpm_step_matches_jax_float32(no_dropout, pretrain, rn_loss):
    """float32. Without the STN: in its train-mode forward a ReLU or pool
    tie moves the control points, and so the rectified image and every
    head downstream (measured: the radical counter's gradients 8e-2 from
    JAX's with the STN, 3e-5 without)."""
    acpm_step(False, pretrain, rn_loss, False, hold=_outside_encoder)
