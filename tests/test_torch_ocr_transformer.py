"""The port's text-focus oracle (models/rec/ocr_transformer.py), its loss
(losses/sr_losses.py) and the SR metrics (eval/metrics.py) against the
JAX package on the CPU: the same seeded numpy inputs, the same weights
(moved through the JAX package's `ocr_transformer` porter), fp32.

The oracle runs at a reduced decoder width (layers (1, 1, 1, 1), d_embed
32, d_model 64, d_ff 64, 4 heads) with the reference's full encoder
channel widths, as the JAX package's own smoke tests do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.eval import metrics as jmetrics
from fudanocr_tpu.losses import sr_losses as jlosses
from fudanocr_tpu.models.rec.ocr_transformer import \
    OCRTransformer as JaxOCRTransformer
from fudanocr_tpu_torch.eval import metrics
from fudanocr_tpu_torch.losses import sr_losses
from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
from fudanocr_tpu_torch.utils.weights import load_jax_variables

ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)
SMALL = dict(vocab=37, num_in=1, layers=(1, 1, 1, 1), num_heads=4,
             d_embed=32, d_model=64, d_ff=64)
B, H, W = 2, 32, 128


def _randomize(variables, rng):
    """Random weights (fan-in scaled), BN statistics away from 0 / 1."""
    def leaf(path, a):
        key = path[-1].key
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
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def oracle_pair():
    """(JAX module, its variables, the port module with those weights)."""
    rng = np.random.default_rng(0)
    jm = JaxOCRTransformer(**SMALL)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((B, H, W, 1)),
                jnp.zeros((B, 4), jnp.int32))
    v = _randomize(jax.tree_util.tree_map(np.asarray, v), rng)
    m = load_jax_variables(OCRTransformer(**SMALL), "ocr_transformer", v,
                           layers=SMALL["layers"])
    return jm, v, m


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(1)
    hr = rng.random((B, H, W, 3)).astype(np.float32)
    sr = rng.random((B, H, W, 3)).astype(np.float32)
    ti, tg, ln = jlosses.encode_text_labels(["Hello!", "a1b2c3d4"], 12)
    return hr, sr, ti, tg, ln


def test_oracle_matches_jax(oracle_pair, sample):
    jm, v, m = oracle_pair
    hr, _, ti, _, _ = sample
    gray = hr[..., :1]
    want = jm.apply(v, jnp.asarray(gray), jnp.asarray(ti))
    with torch.no_grad():
        got = m(torch.from_numpy(gray), torch.from_numpy(ti).long())
    assert got["map"].shape == (B, 4, 12, (H // 4) * (W // 4))
    for k in ("conv", "hidden", "pred", "map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=ATOL, err_msg=k)


def test_oracle_train_mode_batch_statistics_match_jax(oracle_pair, sample,
                                                       monkeypatch):
    """Train mode (dropout off on both sides): BN on batch statistics, and
    the running statistics move as flax moves them."""
    import copy

    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    jm, v, m = oracle_pair
    m = copy.deepcopy(m)
    m.decoder.dropout_rate = 0.0
    for mha in (m.decoder.mask_multihead, m.decoder.multihead):
        mha.dropout_rate = 0.0
    hr, _, ti, _, _ = sample
    gray = hr[..., :1]
    want, upd = jm.apply(v, jnp.asarray(gray), jnp.asarray(ti), train=True,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = m(torch.from_numpy(gray), torch.from_numpy(ti).long(),
                train=True)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]),
                               rtol=1e-3, atol=ATOL)
    enc = m.encoder.cnn
    jb = upd["batch_stats"]["encoder"]
    for port_bn, jax_bn in ((enc.bn1, jb["stem1_bn"]),
                            (enc.layer3[0].downsample[1],
                             jb["stage2_block0"]["down_bn"]),
                            (enc.layer4_conv2_bn, jb["head_bn"])):
        np.testing.assert_allclose(port_bn.running_mean.numpy(),
                                   np.asarray(jax_bn["mean"]), atol=1e-5)
        np.testing.assert_allclose(port_bn.running_var.numpy(),
                                   np.asarray(jax_bn["var"]), rtol=1e-4,
                                   atol=1e-5)


def test_state_dict_keeps_reference_layout():
    keys = set(OCRTransformer(37, num_in=1, layers=(1, 2, 5, 3),
                              num_heads=16).state_dict())
    for k in ("encoder.cnn.conv1.weight", "encoder.cnn.bn2.running_var",
              "encoder.cnn.layer1.0.downsample.0.weight",
              "encoder.cnn.layer3.4.bn2.weight", "encoder.cnn.layer2_conv.bias",
              "encoder.cnn.layer3_bn.running_mean",
              "encoder.cnn.layer4_conv2.weight",
              "encoder.cnn.layer4_conv2_bn.bias", "embedding_word.lut.weight",
              "decoder.mask_multihead.linears.3.weight",
              "decoder.multihead.linears.1.bias",
              "decoder.mul_layernorm2.a_2", "decoder.pff.w_2.weight",
              "generator_word.proj.weight"):
        assert k in keys, k
    assert "encoder.cnn.layer4_conv.weight" not in keys


@pytest.mark.parametrize("preset", ["oracle", "sld", "oictr"])
def test_encoder_presets(preset):
    """The JAX module's encoder presets: the oracle preset is layers
    (1, 2, 5, 3); the wide 3-stage presets end without the head conv, at
    their last stage's width (1024 as well); the memory width sizes the
    cross-attention's key/value linears."""
    m = OCRTransformer(37, num_in=1, encoder_preset=preset, d_embed=32,
                       d_model=64, d_ff=64)
    assert m.encoder.cnn.out_features == 1024
    assert m.decoder.multihead.linears[1].in_features == 1024
    keys = set(m.state_dict())
    assert ("encoder.cnn.layer4_conv2.weight" in keys) == (preset != "oictr")
    if preset == "oracle":
        assert keys == set(OCRTransformer(37, num_in=1, layers=(1, 2, 5, 3),
                                          d_embed=32, d_model=64,
                                          d_ff=64).state_dict())


@pytest.mark.parametrize("cached", [False, True])
def test_text_focus_loss_and_sr_gradient_match_jax(oracle_pair, sample,
                                                   cached):
    """Loss, its terms and d loss / d SR against the JAX loss, with the HR
    map computed live or passed in (SRTrainer's cache); the confusion
    table on."""
    jm, v, m = oracle_pair
    hr, sr, ti, tg, ln = sample
    table = np.random.default_rng(2).random((37, 37)).astype(np.float32) + .5
    jfn = jlosses.TextFocusLoss(jm, v, weight_table=table)
    pfn = sr_losses.TextFocusLoss(m, weight_table=table)
    jargs = [jnp.asarray(a) for a in (hr, ti, tg, ln)]
    targs = [torch.from_numpy(hr)] + [torch.from_numpy(a).long()
                                      for a in (ti, tg, ln)]
    jextra = ({"hr_map": jfn.hr_oracle_map(jargs[0], jargs[1])}
              if cached else {})
    textra = ({"hr_map": pfn.hr_oracle_map(targs[0], targs[1])}
              if cached else {})

    def jloss(s):
        return jfn(s, *jargs, **jextra)

    (want, want_aux), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(sr))
    s = torch.from_numpy(sr).requires_grad_()
    got, aux = pfn(s, *targs, **textra)
    got.backward()
    assert not any(p.requires_grad for p in m.parameters())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for k in ("mse", "attention", "recognition"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=1e-3, atol=1e-7, err_msg=k)
    scale = np.abs(np.asarray(want_g)).max()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-3 * scale)


def test_label_codec_and_weighted_ce_match_jax():
    labels = ["Hello, World", "", "x" * 40, "12abZ"]
    for a, b in zip(sr_losses.encode_text_labels(labels, 16),
                    jlosses.encode_text_labels(labels, 16)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((4, 16, 37)).astype(np.float32)
    gt = rng.integers(0, 37, (4, 16))
    mask = rng.random((4, 16)) < 0.7
    table = rng.random((37, 37)).astype(np.float32) + 0.1
    for t in (None, table):
        want = jlosses.weighted_cross_entropy(
            jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask),
            None if t is None else jnp.asarray(t))
        got = sr_losses.weighted_cross_entropy(
            torch.from_numpy(pred), torch.from_numpy(gt),
            torch.from_numpy(mask), None if t is None else torch.from_numpy(t))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_confuse_table_matches_jax(tmp_path):
    import pickle

    raw = np.random.default_rng(4).integers(0, 50, (62, 62)).astype(
        np.float64)
    path = tmp_path / "confuse.pkl"
    path.write_bytes(pickle.dumps(raw))
    np.testing.assert_array_equal(
        sr_losses.load_confuse_weight_table(str(path)),
        jlosses.load_confuse_weight_table(str(path)))


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.random((3, 32, 128, 3)).astype(np.float32)
    b = np.clip(a + rng.standard_normal(a.shape) * 0.1, 0, 1).astype(
        np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(metrics.psnr(ta, tb).item(),
                               float(jmetrics.psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim(ta, tb).item(),
                               float(jmetrics.ssim(a, b)), rtol=1e-4)
    for s in ("Hello, World!", "ÄbC-12", ""):
        for voc in ("digit", "lower", "upper", "all"):
            assert metrics.str_filt(s, voc) == jmetrics.str_filt(s, voc)
    preds, gts = ["hello", "W0rld", "x"], ["Hello!", "world", "x"]
    assert (metrics.sequence_accuracy(preds, gts)
            == jmetrics.sequence_accuracy(preds, gts))
    assert metrics.sequence_accuracy([], []) == 0.0
