"""TBSRN parity: the PyTorch port against the JAX package on the CPU, the
same seeded LR batch and the same weights (moved with
fudanocr_tpu_torch.utils.weights.load_jax_variables), fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN
from fudanocr_tpu_torch.models.sr import TBSRN
from fudanocr_tpu_torch.utils.weights import load_jax_variables

SRB = 2
ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)


def _randomize_stats(variables, rng):
    """Non-trivial BN statistics and LN scales (inits are 0 / 1)."""
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


@pytest.fixture(scope="module")
def lr():
    return np.random.default_rng(0).random((2, 16, 64, 3)).astype(np.float32)


def _jax_model(**kw):
    return JaxTBSRN(scale_factor=2, width=128, height=32, stn=True,
                    srb_nums=SRB, hidden_units=32, **kw)


def _port(variables):
    return load_jax_variables(TBSRN(srb_nums=SRB), "tbsrn", variables,
                              srb_nums=SRB).eval()


def test_tbsrn_matches_jax(lr):
    jm = _jax_model(wide_out_block=0)
    v = _randomize_stats(jm.init(jax.random.PRNGKey(1), jnp.asarray(lr)),
                         np.random.default_rng(1))
    want = np.asarray(jm.apply(v, jnp.asarray(lr)))
    m = _port(v)
    with torch.inference_mode():
        got = m(torch.from_numpy(lr)).numpy()
    assert got.shape == (2, 32, 128, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=ATOL)


def test_default_head_params_port(lr):
    """The JAX default (lane-packed 9x9 head, wide_out_block=32) keeps the
    plain conv's parameters, so its weights load into the port's Conv2d
    head unchanged."""
    v = _jax_model().init(jax.random.PRNGKey(2), jnp.asarray(lr))
    plain = _jax_model(wide_out_block=0).init(jax.random.PRNGKey(2),
                                              jnp.asarray(lr))
    assert (jax.tree_util.tree_structure(v)
            == jax.tree_util.tree_structure(plain))
    m = _port(jax.tree_util.tree_map(np.asarray, v))
    k = np.asarray(v["params"]["out_conv"]["kernel"])
    np.testing.assert_array_equal(
        m.block5[-1].weight.detach().numpy(), k.transpose(3, 2, 0, 1))


def test_state_dict_keeps_reference_layout():
    keys = set(TBSRN(srb_nums=SRB).state_dict())
    for k in ("block1.0.weight", "block1.1.weight",
              "block2.feature_enhancer.multihead.linears.3.weight",
              "block3.feature_enhancer.mul_layernorm1.a_2",
              "block3.feature_enhancer.pff.w_1.weight",
              "block2.feature_enhancer.mul_layernorm3.b_2",
              "block2.feature_enhancer.linear.bias", "block2.bn2.running_var",
              "block4.0.weight", "block4.1.running_mean",
              "block5.0.conv.weight", "block5.1.weight",
              "stn_head.stn_convnet.10.1.weight", "stn_head.stn_fc2.bias"):
        assert k in keys, k


def test_train_mode_not_ported():
    """The train path is ported now (held against the JAX step in
    tests/test_torch_sr_train.py): it runs, moves the BatchNorm statistics
    and gives the HR shape; with dropout on, the generator decides it."""
    torch.manual_seed(0)
    m = TBSRN(srb_nums=1)
    x = torch.rand(2, 16, 64, 3)
    before = m.block2.bn1.running_var.clone()
    a = m(x, train=True, generator=torch.Generator().manual_seed(1))
    assert a.shape == (2, 32, 128, 3) and torch.isfinite(a).all()
    assert not torch.equal(m.block2.bn1.running_var, before)
    b = m(x, train=True, generator=torch.Generator().manual_seed(1))
    c = m(x, train=True, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
