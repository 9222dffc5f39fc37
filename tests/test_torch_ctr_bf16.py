"""The CTR models in bf16 against the JAX package's bf16 on the CPU: SLD's
OCRTransformer, OICTR, CCRCLIP (both towers and the stage-1 loss; the ViT
tower too) and ACPM built with `dtype=torch.bfloat16` against the JAX
modules with `dtype=jnp.bfloat16`, from the same float32 weights (the
porters), on the same seeded inputs; the decodes by the top-2 margin rule
(the training steps: tests/test_torch_ctr_bf16_steps.py and
tests/test_torch_ctr_bf16_clip_acpm_steps.py).

The packages round to bf16 at other places (XLA:CPU's and torch's CPU
convolutions and products; torch's bf16 CPU convolutions run through
`nn/layers.conv2d`'s float32 route, ROADMAP C24), so an output's bf16
distance between them is of the size of either one's distance from
float32. The bars, the seg models' (tests/test_torch_seg_bf16.py): each
output within twice JAX's own bf16 distance from JAX's float32 output
("jaxs", norm-relative to the float32 output) of JAX's bf16 output and of
JAX's float32 output, and no nearer float32 than jaxs / 8 (a float32
forward fails). Decoded ids: equal to JAX's bf16 decode up to each row's
first difference, where JAX's top-2 margin lies within twice the measured
distance of the two packages' bf16 step outputs (`check_ids`); that
distance within twice JAX's own bf16 distance from float32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.rec import ocr_transformer as jocr
from fudanocr_tpu.models.rec.oictr import OICTR as JaxOICTR
from fudanocr_tpu_torch.models.rec import ocr_transformer
from fudanocr_tpu_torch.models.rec.oictr import OICTR
from fudanocr_tpu_torch.utils.weights import load_jax_variables
from test_torch_ctr_acpm import _jax_model, _pair as acpm_pair
from torch_ctr_cases import CLIP, CLIP_VISION, OICTR as OI, SLD, check_ids
from torch_ctr_step_cases import clip_jax, clip_text
from torch_threads import one_torch_thread  # noqa: F401

B, L = 2, 8
BF = torch.bfloat16


def _rel(a, b, ref) -> float:
    a, b, ref = (np.asarray(t, np.float64) for t in (a, b, ref))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(ref), 1e-30))


def hold_bf16(got, want_bf16, want_fp32, name):
    """The forward bar of the module docstring; returns (ours, jaxs)."""
    ours = _rel(got, want_bf16, want_fp32)
    ours32 = _rel(got, want_fp32, want_fp32)
    jaxs = _rel(want_bf16, want_fp32, want_fp32)
    assert ours <= 2 * jaxs and ours32 <= 2 * jaxs, (name, ours, ours32,
                                                     jaxs)
    assert ours32 >= jaxs / 8, (name, ours32, jaxs)
    return ours, jaxs


def _tokens(vocab, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def models(which):
    """(JAX float32 module, JAX bf16 module, variables, the port's bf16
    module, input image shape (H, W), vocab)."""
    from torch_ctr_cases import init

    if which == "sld":
        j32, jbf = (jocr.OCRTransformer(**SLD, dtype=d)
                    for d in (None, jnp.bfloat16))
        v = init(j32, np.zeros((B, 32, 32, 3), np.float32),
                 np.zeros((B, L), np.int32))
        m = load_jax_variables(ocr_transformer.OCRTransformer(
            **SLD, dtype=BF), "ocr_transformer", v, layers=SLD["layers"])
        return j32, jbf, v, m, (32, 32), SLD["vocab"]
    if which == "oictr":
        j32, jbf = (JaxOICTR(**OI, dtype=d) for d in (None, jnp.bfloat16))
        v = init(j32, np.zeros((B, 32, 64, 3), np.float32),
                 np.zeros((B, L), np.int32))
        m = load_jax_variables(OICTR(image_size=(32, 64), **OI, dtype=BF),
                               "oictr", v)
        return j32, jbf, v, m, (32, 64), OI["vocab"]
    j32, v, _ = _jax_model("resnet", False, "L1")
    jbf, _, _ = _jax_model("resnet", False, "L1", True)
    _, _, m = acpm_pair(dtype=BF)
    return j32, jbf, v, m, (32, 32), j32.vocab


def _images_hw(hw, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("which", ["sld", "oictr", "acpm"])
def test_decoder_models_bf16_forward_match_jax(which):
    """Every output of SLD's OCRTransformer, OICTR and ACPM (logits, map,
    memory, decoder output; OICTR's char maps, direction branch and
    reconstructions; ACPM's profile heads), bf16 on both sides."""
    j32, jbf, v, m, hw, vocab = models(which)
    x, t = _images_hw(hw, 1), _tokens(vocab)
    want32, wantbf = (jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t))
                      for jm in (j32, jbf))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.keys() == wantbf.keys()
    assert got["pred"].dtype == BF and got["conv"].dtype == BF
    for k in wantbf:
        ours, jaxs = hold_bf16(got[k].float().numpy(), wantbf[k],
                               want32[k], k)
        print(f"{which} {k}: ours {ours:.2e}, jaxs {jaxs:.2e}")


def test_clip_bf16_towers_and_loss_match_jax(monkeypatch):
    """Both towers' unit features, and the stage-1 loss (the symmetric CE
    with first-occurrence targets) on them, bf16 on both sides."""
    from fudanocr_tpu.losses.clip_loss import clip_symmetric_ce as jloss
    from fudanocr_tpu.models.rec import ccr_clip as jccr
    from fudanocr_tpu_torch.losses.clip_loss import clip_symmetric_ce
    from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP
    from torch_ctr_cases import small_clip_vision

    j32, v = clip_jax()
    small_clip_vision(monkeypatch)
    jbf = jccr.CCRCLIP(**CLIP, dtype=jnp.bfloat16)
    m = load_jax_variables(
        CCRCLIP(vision_layers=CLIP_VISION, **CLIP, dtype=BF), "ccr_clip", v,
        layers=CLIP_VISION, transformer_layers=CLIP["transformer_layers"])
    x = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    t = clip_text(9)
    targets = np.array([0, 1], np.int32)
    want32, wantbf = (jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t))
                      for jm in (j32, jbf))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t).long())
    for name, g, wb, w32 in zip(("image", "text", "scale"), got, wantbf,
                                want32):
        assert g.dtype == torch.float32
        if name != "scale":
            ours, jaxs = hold_bf16(g.numpy(), wb, w32, name)
            print(f"clip {name}: ours {ours:.2e}, jaxs {jaxs:.2e}")
    loss = clip_symmetric_ce(*got, torch.from_numpy(targets).long()).item()
    lbf, l32 = (float(jloss(*w, jnp.asarray(targets)))
                for w in (wantbf, want32))
    print(f"clip loss {loss} vs bf16 {lbf}, fp32 {l32}")
    # the bf16 training bar's loss term (PERF.md section 2): the loss of
    # random towers sits near ln 2, where bf16 moves it by ~2e-6 only
    assert abs(loss - lbf) <= 1e-2 * abs(lbf)


def test_clip_vit_bf16_matches_jax():
    """The ViT image tower the reference defines beside the ResNet
    (tests/test_torch_ctr_clip.py's size)."""
    from fudanocr_tpu.models.rec import ccr_clip as jccr
    from fudanocr_tpu_torch.models.rec.ccr_clip import VisionTransformer
    from torch_ctr_cases import init

    kw = dict(patch_size=16, width=32, layers=1, heads=2, output_dim=16)
    j32, jbf = (jccr.VisionTransformer(**kw, dtype=d)
                for d in (None, jnp.bfloat16))
    v = init(j32, np.zeros((B, 32, 32, 3), np.float32))
    m = load_jax_variables(VisionTransformer((32, 32), 16, 32, 1, 2, 16,
                                             dtype=BF), "clip_vit", v,
                           layers=1)
    x = _images_hw((32, 32), 3)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.dtype == BF
    ours, jaxs = hold_bf16(got.float().numpy(),
                           *(jax.jit(jm.apply)(v, jnp.asarray(x))
                             for jm in (jbf, j32)), "vit")
    print(f"vit: ours {ours:.2e}, jaxs {jaxs:.2e}")


@pytest.mark.parametrize("which", ["sld", "oictr", "acpm"])
def test_bf16_greedy_decode_matches_jax(which):
    j32, jbf, v, m, hw, _ = models(which)
    x = _images_hw(hw, 5)
    want = jocr.greedy_decode(jbf, v, jnp.asarray(x), 6)
    got = ocr_transformer.greedy_decode(m, torch.from_numpy(x), 6)
    assert got.shape == (B, 6) and got.dtype == torch.int64
    buf = np.concatenate([np.zeros((B, 1), np.int32),
                          np.asarray(want, np.int32)], 1)

    def scores(jm):
        out, _, _ = jax.jit(lambda v, x, t: jm.apply(
            v, jm.apply(v, x, method=jm.encode), t,
            method=jm.decode_step))(v, jnp.asarray(x), jnp.asarray(buf))
        return np.asarray(out, np.float64)[:, :-1]

    wbf, w32 = scores(jbf), scores(j32)
    with torch.no_grad():
        gs, _, _ = m.decode_step(m.encode(torch.from_numpy(x)),
                                 torch.from_numpy(buf).long())
    err, ties = check_ids(got.numpy(), want, gs.float().numpy()[:, :-1], wbf)
    jaxs = np.abs(wbf - w32).max()
    print(f"{which} decode: step outputs max abs {err:.3e} (JAX bf16 vs "
          f"fp32 {jaxs:.3e}), {ties} rows split at a near tie")
    assert err <= 2 * jaxs
