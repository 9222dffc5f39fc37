"""The port's bf16 inference against the JAX package's bf16 inference on the
CPU: TBSRN on both enhancer routes, CRNN's CTC ids through
`PixelsToStrings(device="cpu")`, and TSRN, on the same weights (moved with
`load_jax_variables`) and the same seeded numpy inputs.

The packages round to bf16 at other places (XLA:CPU and torch's CPU
kernels, the attention's probabilities), so the port's bf16 output is not
JAX's bf16 output; both are bf16 approximations of the same fp32 function.
The yardstick is what bf16 moves in JAX itself: `jaxs`, JAX's bf16 output's
distance from JAX's fp32 output (max abs and mean abs). Bars:

* the port's bf16 output is no further from JAX's fp32 output than twice
  `jaxs`, in max and in mean;
* it is at least a quarter of `jaxs` away in mean, so that a port that ran
  in fp32 whatever its `dtype` fails (an fp32 port sits at ~1e-6);
* CTC ids equal JAX's bf16 ids at every step where JAX's top-2 logit
  margin exceeds twice the largest logit difference measured between the
  two, and the logits obey the first two bars against JAX's fp32 logits.

Each test prints what it measured (`-s`); the numbers are stated in the
docstrings below (CPU, torch 2.13, jax 0.9). The JAX models run their
plain chains (no Pallas kernel on the CPU); the port's kernels run their
plain versions, which the `cuda` tests hold the kernels to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.rec.crnn import CRNN as JaxCRNN
from fudanocr_tpu.models.rec.crnn import parse_crnn_input as jax_crnn_input
from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN
from fudanocr_tpu.models.sr import TSRN as JaxTSRN
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter
from fudanocr_tpu_torch.models.rec.crnn import CRNN, parse_crnn_input
from fudanocr_tpu_torch.models.sr import TBSRN, TSRN
from fudanocr_tpu_torch.models.sr import tbsrn as port_tbsrn
from fudanocr_tpu_torch.nn import attention as port_attention
from fudanocr_tpu_torch.nn import recurrent
from fudanocr_tpu_torch.serving import PixelsToStrings
from fudanocr_tpu_torch.utils.weights import load_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"
SRB, BATCH = 2, 4
LR_HW = (16, 64)     # TextZoom's LR: 1024 enhancer tokens, the fused gate
SR_KW = dict(scale_factor=2, width=128, height=32, stn=True, srb_nums=SRB)
CRNN_HIDDEN = 32


def _randomize(variables, rng):
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


def _dist(a, b) -> tuple:
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.max()), float(d.mean())


def _check_bars(what: str, ours: tuple, jaxs: tuple) -> None:
    print(f"{what}: port bf16 from JAX fp32 max {ours[0]:.4g} mean "
          f"{ours[1]:.4g}; JAX bf16 from JAX fp32 max {jaxs[0]:.4g} mean "
          f"{jaxs[1]:.4g}")
    assert ours[0] <= 2 * jaxs[0], (what, "max", ours, jaxs)
    assert ours[1] <= 2 * jaxs[1], (what, "mean", ours, jaxs)
    assert ours[1] >= jaxs[1] / 4, (what, "fp32 port?", ours, jaxs)


@pytest.fixture(scope="module")
def lr():
    return np.random.default_rng(0).random((BATCH, *LR_HW, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def tbsrn(lr):
    """(JAX fp32 variables, JAX fp32 SR, JAX bf16 SR)."""
    jm = JaxTBSRN(**SR_KW, hidden_units=32, wide_out_block=0)
    v = _randomize(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(lr))), np.random.default_rng(1))
    fp32 = np.asarray(jm.apply(v, jnp.asarray(lr)))
    jbf = JaxTBSRN(**SR_KW, hidden_units=32, wide_out_block=0,
                   dtype=jnp.bfloat16)
    bf16 = np.asarray(jbf.apply(v, jnp.asarray(lr)), np.float32)
    return v, fp32, bf16


def _port_tbsrn(v, fused: bool) -> TBSRN:
    m = TBSRN(**SR_KW, dtype=torch.bfloat16, fused_enhancer=fused)
    return load_jax_variables(m, "tbsrn", v, srb_nums=SRB).eval()


@pytest.mark.parametrize("fused", [True, False])
def test_tbsrn_bf16_matches_jax_bf16(tbsrn, lr, monkeypatch, fused):
    """TBSRN at 2 SRBs, batch 4, LR 16x64 (L = 1024: the fused enhancer's
    gate passes), on the fused route (the kernel's plain version on the
    CPU, 2 calls) and the unfused one (B3's plain version, 2 calls).
    Measured: JAX bf16 from JAX fp32 max 0.0276, mean 4.08e-3; the port
    fused 0.0277 / 3.78e-3, unfused 0.0300 / 3.80e-3."""
    v, fp32, bf16 = tbsrn
    calls = []
    for mod, name in ((port_tbsrn, "fused_enhancer"),
                      (port_attention, "flash_mha_qkv_packed")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    m = _port_tbsrn(v, fused)
    with torch.inference_mode():
        got = m(torch.from_numpy(lr)).float().numpy()
    assert got.shape == fp32.shape and np.isfinite(got).all()
    route = "fused_enhancer" if fused else "flash_mha_qkv_packed"
    assert calls == [route] * SRB
    _check_bars(f"TBSRN {route}", _dist(got, fp32), _dist(bf16, fp32))


def test_pixels_to_strings_bf16_ctc_ids_match_jax(tbsrn, lr):
    """TBSRN (fused route) -> bicubic 32x100 gray -> CRNN(37, 32) in bf16
    through `PixelsToStrings(device="cpu")`, against the same chain of the
    JAX package in bf16 (and fp32 for the logits' yardstick).
    Measured: logits, JAX bf16 from JAX fp32 max 1.97e-3, mean 3.05e-4;
    the port 2.07e-3 / 2.83e-4; all 104 steps have a JAX top-2 margin
    above twice the port's largest logit difference from JAX bf16
    (3.9e-3), and the ids are equal at all of them."""
    v, sr32, sr_bf = tbsrn
    jc = JaxCRNN(num_classes=37, hidden=CRNN_HIDDEN)
    cv = _randomize(jax.tree_util.tree_map(np.asarray, jc.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 100, 1)))),
        np.random.default_rng(2))
    jc_bf = JaxCRNN(num_classes=37, hidden=CRNN_HIDDEN, dtype=jnp.bfloat16)
    want32 = np.asarray(jc.apply(cv, jax_crnn_input(jnp.asarray(sr32))))
    want = np.asarray(jc_bf.apply(cv, jax_crnn_input(
        jnp.asarray(sr_bf, jnp.bfloat16))), np.float32)

    sr = _port_tbsrn(v, fused=True)
    crnn = load_jax_variables(CRNN(37, CRNN_HIDDEN, dtype=torch.bfloat16),
                              "crnn", cv).eval()
    pipe = PixelsToStrings(sr, crnn, CTCLabelConverter(ALPHABET),
                           device="cpu")
    ids, sr_out = pipe.ids_and_sr(lr)
    with torch.inference_mode():
        logits = crnn(parse_crnn_input(sr_out)).float().numpy()
    assert logits.shape == want.shape and np.isfinite(logits).all()
    np.testing.assert_array_equal(ids.numpy(), logits.argmax(-1))
    _check_bars("CRNN logits", _dist(logits, want32), _dist(want, want32))
    err = _dist(logits, want)[0]
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * err
    same = ids.numpy() == want.argmax(-1)
    print(f"CTC ids: {int(sure.sum())} of {sure.size} steps have a JAX "
          f"top-2 margin above {2 * err:.4g}; equal there: "
          f"{bool(same[sure].all())}; equal at all steps: "
          f"{int(same.sum())}")
    assert same[sure].all()


def test_tsrn_bf16_matches_jax_bf16(lr, monkeypatch):
    """TSRN at 2 SRBs, hidden 8, batch 4, LR 16x64 (STN on), with
    `fused_gru=True`: gru1's 4 x 64 = 256 rows pass the B8 gate, so it runs
    B8's plain version on the CPU (2 calls); gru2 runs the GRU.
    Measured: JAX bf16 from JAX fp32 max 9.21e-3, mean 1.67e-3; the port
    9.33e-3 / 1.48e-3."""
    kw = dict(scale_factor=2, width=128, height=32, stn=True, srb_nums=SRB,
              hidden_units=8)
    jm = JaxTSRN(**kw)
    v = _randomize(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(3), jnp.asarray(lr))), np.random.default_rng(3))
    fp32 = np.asarray(jm.apply(v, jnp.asarray(lr)))
    bf16 = np.asarray(JaxTSRN(**kw, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(lr)), np.float32)
    calls = []
    real = recurrent.fused_bigru_x
    monkeypatch.setattr(recurrent, "fused_bigru_x",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    m = load_jax_variables(TSRN(**kw, dtype=torch.bfloat16, fused_gru=True),
                           "tsrn", v, srb_nums=SRB, stn=True).eval()
    with torch.inference_mode():
        got = m(torch.from_numpy(lr)).float().numpy()
    assert got.shape == fp32.shape and np.isfinite(got).all()
    assert len(calls) == SRB
    _check_bars("TSRN", _dist(got, fp32), _dist(bf16, fp32))
