"""TSRN in train mode against `jax.grad` on the CPU (helpers and bars in
tests/test_torch_tsrn.py, whose docstring says what is held)."""

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.utils.weights import (grad_state_dict,
                                              to_jax_variables)
from test_torch_tsrn import ATOL, SRB, _leaves, _port, _setup, jx  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("stn,hw,batch", [(False, (8, 16), 2),
                                          (True, (16, 64), 2)])
def test_tsrn_train_mode_matches_jax(jx, stn, hw, batch):
    """Output, BatchNorm statistics after the forward, and the gradient
    of sum(out * w) in every parameter, each leaf held to 1e-3 of its
    norm, with two stated exceptions:

    * the conv biases in front of a train-mode BatchNorm have exactly
      zero gradients up to rounding: held to 1e-6 of the largest
      gradient's norm, as phase 6a of chip_smoke.py holds them;
    * with the STN on, the two packages round the TPS sampling
      coordinates differently by ~1e-6 of the image width
      (tests/test_torch_sr_train.py::test_tps_matches_jax), which moves
      the warped pixels by ~1e-4; the leaves that read the warped image
      (the stem) or sum over every sampled pixel (the STN head) are held
      to 5e-3 of their norm.

    The fused flag is on and takes no effect: training keeps the GRU of
    autograd, as JAX keeps its scan."""
    jax, jnp, _ = jx
    jm, v, x = _setup(jx, stn, hw, batch, seed=2)
    wgt = np.random.default_rng(3).standard_normal(
        (batch, 2 * hw[0], 2 * hw[1], 3)).astype(np.float32)

    def loss(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * wgt), (out, upd)

    (_, (want, upd)), grads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    m = _port(v, stn, hw, fused_gru=True)
    got = m(torch.from_numpy(x), train=True)
    (got * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-3, atol=ATOL)
    back = to_jax_variables(m, "tsrn", srb_nums=SRB, stn=stn)
    gback = to_jax_variables(grad_state_dict(m), "tsrn", srb_nums=SRB,
                             stn=stn)
    for tree, want_tree in ((back["batch_stats"], upd["batch_stats"]),
                            (gback["params"], grads)):
        g, w = _leaves(jax, tree), _leaves(jax, want_tree)
        assert g.keys() == w.keys()
        top = max(np.linalg.norm(a) for a in w.values())
        for k in w:
            norm = np.linalg.norm(w[k])
            rel = (5e-3 if stn and k.startswith(("['stn_head']",
                                                 "['stem_")) else 1e-3)
            bar = 1e-6 * top if norm <= 1e-6 * top else rel * norm
            assert np.linalg.norm(g[k] - w[k]) <= bar, k
