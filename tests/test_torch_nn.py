"""Layer-level parity of the PyTorch port (fudanocr_tpu_torch/nn, ops/resize)
against the JAX package on the CPU: the same seeded numpy inputs and
weights through both, compared in fp32. Weights move through the port's
porter functions (utils/porters.py) inverted by `utils/weights.py`, as
`load_jax_variables` does for whole models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fudanocr_tpu.nn import attention as jattn
from fudanocr_tpu.nn import layers as jl
from fudanocr_tpu.nn.recurrent import BiLSTM as JaxBiLSTM
from fudanocr_tpu.nn.stn import STNHead as JaxSTNHead
from fudanocr_tpu.ops.resize import resize_bicubic_torch as jax_resize
from fudanocr_tpu_torch.nn import attention as pattn
from fudanocr_tpu_torch.nn import layers as pl
from fudanocr_tpu_torch.nn.recurrent import BiLSTM
from fudanocr_tpu_torch.nn.stn import STNHead
from fudanocr_tpu_torch.ops.resize import resize_bicubic_torch
from fudanocr_tpu_torch.utils import porters
from fudanocr_tpu_torch.utils.weights import load_jax_variables

ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)


def _randomize(variables, rng, scale=0.3):
    """Every leaf random, batch variances positive."""
    def leaf(path, a):
        r = rng.standard_normal(a.shape).astype(np.float32) * scale
        if path[-1].key == "var":
            return np.abs(r) + 0.5
        return r + (1.0 if path[-1].key == "scale" else 0.0)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_mish():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(pl.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.mish(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("residual", [False, True])
def test_torch_layer_norm(residual):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    r = rng.standard_normal((16, 128)).astype(np.float32) if residual else None
    v = _randomize(jl.TorchLayerNorm().init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)), rng)
    want = jl.TorchLayerNorm().apply(
        v, jnp.asarray(x), None if r is None else jnp.asarray(r))
    m = pl.TorchLayerNorm(128)
    m.load_state_dict({"a_2": torch.from_numpy(v["params"]["scale"]),
                       "b_2": torch.from_numpy(v["params"]["bias"])})
    got = m(torch.from_numpy(x), None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_prelu():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    want = jl.PReLU().apply({"params": {"alpha": np.array([0.4], np.float32)}},
                            jnp.asarray(x))
    m = pl.PReLU()
    m.load_state_dict({"weight": torch.tensor([0.4])})
    np.testing.assert_array_equal(m(torch.from_numpy(x)).detach().numpy(),
                                  np.asarray(want))


def test_pixel_shuffle_channel_order():
    x = np.random.default_rng(1).random((2, 3, 5, 12)).astype(np.float32)
    want = np.asarray(jl.pixel_shuffle(jnp.asarray(x), 2))
    np.testing.assert_array_equal(_nhwc(pl.pixel_shuffle(_nchw(x), 2)), want)


def test_max_pool_with_width_padding():
    x = np.random.default_rng(2).standard_normal((2, 8, 10, 4)).astype(
        np.float32)
    want = jl.max_pool(jnp.asarray(x), (2, 2), (2, 1), padding=[(0, 0), (1, 1)])
    got = pl.max_pool(_nchw(x), (2, 2), (2, 1), (0, 1))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_conv_bn_relu():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    jm = jl.ConvBNReLU(7)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jm.apply(v, jnp.asarray(x))
    p, s = v["params"], v["batch_stats"]["BatchNorm_0"]
    m = pl.ConvBNReLU(5, 7).eval()
    m.load_state_dict({
        "0.weight": torch.from_numpy(
            p["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "0.bias": torch.from_numpy(p["Conv_0"]["bias"]),
        "1.weight": torch.from_numpy(p["BatchNorm_0"]["scale"]),
        "1.bias": torch.from_numpy(p["BatchNorm_0"]["bias"]),
        "1.running_mean": torch.from_numpy(s["mean"]),
        "1.running_var": torch.from_numpy(s["var"]),
        "1.num_batches_tracked": torch.tensor(0)})
    np.testing.assert_allclose(_nhwc(m(_nchw(x))), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("args", [("1d", 64, 50), ("2d", 64, 16, 64),
                                  ("2d", 32, 5, 7)])
def test_positional_encodings_equal(args):
    name = f"positional_encoding_{args[0]}"
    np.testing.assert_array_equal(getattr(pattn, name)(*args[1:]),
                                  getattr(jattn, name)(*args[1:]))


def test_multi_head_attention_self_path():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, 128)).astype(np.float32)
    jm = jattn.MultiHeadAttention(num_heads=4, d_model=128)
    xj = jnp.asarray(x)
    v = _randomize(jm.init(jax.random.PRNGKey(0), xj, xj, xj), rng, 0.1)
    want, _ = jm.apply(v, xj, xj, xj, need_weights=False)
    qkv, out = v["params"]["qkv"], v["params"]["out"]
    sd = {}
    for i in range(3):
        sd[f"linears.{i}.weight"] = qkv["kernel"][:, i * 128:(i + 1) * 128].T
        sd[f"linears.{i}.bias"] = qkv["bias"][i * 128:(i + 1) * 128]
    sd["linears.3.weight"], sd["linears.3.bias"] = out["kernel"].T, out["bias"]
    m = pattn.MultiHeadAttention(4, 128)
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a))
                       for k, a in sd.items()})
    xt = torch.from_numpy(x)
    got, probs = m(xt, xt, xt, need_weights=False)
    assert probs is None
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


class _Holder(nn.Module):
    """Puts a module under the name a porter reads."""

    def __init__(self, name, module):
        super().__init__()
        self.add_module(name, module)


def test_stn_head(monkeypatch):
    """STNHead weights through the porter's _stn_head; the control points
    and the embedding agree with the JAX head."""
    monkeypatch.setitem(porters.PORTERS, "_stn", lambda sd: dict(
        zip(("params", "batch_stats"), porters._stn_head(sd))))
    rng = np.random.default_rng(5)
    x = rng.random((2, 16, 64, 3)).astype(np.float32)
    jm = JaxSTNHead(num_ctrlpoints=20)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, 0.1)
    want_feat, want_pts = jm.apply(v, jnp.asarray(x))
    holder = load_jax_variables(_Holder("stn_head", STNHead(3, 20)), "_stn",
                                v).eval()
    with torch.inference_mode():
        feat, pts = holder.stn_head(_nchw(x))
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat),
                               rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(pts.numpy(), np.asarray(want_pts),
                               rtol=1e-4, atol=ATOL)


def test_bilstm(monkeypatch):
    """nn.LSTM-based BiLSTM against the JAX lax.scan BiLSTM, weights
    through the porter's `birnn`."""
    monkeypatch.setitem(porters.PORTERS, "_birnn", lambda sd: {
        "params": porters.birnn(sd, "rnn")})
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 9, 20)).astype(np.float32)
    jm = JaxBiLSTM(16)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jm.apply(v, jnp.asarray(x))
    holder = load_jax_variables(_Holder("rnn", BiLSTM(20, 16)), "_birnn", v)
    with torch.inference_mode():
        got = holder.rnn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((32, 128), (32, 100)),
                                          ((16, 64), (32, 100)),
                                          ((7, 9), (4, 23))])
def test_resize_bicubic_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(7).random((2, *in_hw, 3)).astype(np.float32)
    want = jax_resize(jnp.asarray(x), out_hw)
    got = resize_bicubic_torch(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
