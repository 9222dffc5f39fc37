"""CRNN parity: the PyTorch port against the JAX package on the CPU, the
same seeded input and weights (through load_jax_variables), fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.eval.ctc import CTCLabelConverter as JaxConverter
from fudanocr_tpu.models.rec.crnn import CRNN as JaxCRNN
from fudanocr_tpu.models.rec.crnn import parse_crnn_input as jax_parse
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter, ctc_greedy_decode
from fudanocr_tpu_torch.models.rec.crnn import CRNN, parse_crnn_input
from fudanocr_tpu_torch.utils.weights import load_jax_variables

ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)
ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"


def _randomize_stats(variables, rng):
    def leaf(path, a):
        key = path[-1].key
        if key == "var":
            return (rng.random(a.shape) * 0.5 + 0.75).astype(np.float32)
        if key == "mean":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def test_crnn_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 100, 1)).astype(np.float32)
    jm = JaxCRNN(num_classes=37, hidden=32)
    v = _randomize_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = load_jax_variables(CRNN(37, 32), "crnn", v).eval()
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 26, 37)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=ATOL)


@pytest.mark.parametrize("hw", [(16, 64), (32, 128), (8, 20)])
def test_parse_crnn_input_matches_jax(hw):
    img = np.random.default_rng(1).random((2, *hw, 3)).astype(np.float32)
    got = parse_crnn_input(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_parse(jnp.asarray(img)))
    assert got.shape == (2, 32, 100, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ctc_codec_matches_jax():
    ids = np.random.default_rng(2).integers(0, 37, (5, 26))
    logits = np.eye(37, dtype=np.float32)[ids]
    got_ids = ctc_greedy_decode(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got_ids, ids)
    ours, ref = CTCLabelConverter(ALPHABET), JaxConverter(ALPHABET)
    assert ours.decode_ids(got_ids) == ref.decode_ids(ids)
    for a, b in zip(ours.encode(["Hello", "w0rld!"], 8),
                    ref.encode(["Hello", "w0rld!"], 8)):
        np.testing.assert_array_equal(a, b)


def test_state_dict_keeps_reference_layout():
    keys = set(CRNN(37, 32).state_dict())
    for k in ("cnn.conv0.weight", "cnn.conv6.bias", "cnn.batchnorm2.weight",
              "cnn.batchnorm6.running_var", "rnn.0.rnn.weight_ih_l0",
              "rnn.1.rnn.bias_hh_l0_reverse", "rnn.0.embedding.weight",
              "rnn.1.embedding.bias"):
        assert k in keys, k
