"""The CTR models of the port against the JAX package on the CPU: the SLD
and CCR-CLIP stage-2 OCRTransformers (models/rec/ocr_transformer.py),
OICTR (models/rec/oictr.py) and the greedy decoders (CCR-CLIP's towers:
tests/test_torch_ctr_clip.py). The same seeded numpy inputs, the same random
weights moved by the port's porters (`load_jax_variables`), fp32; the
JAX package's smoke sizes (tests/torch_ctr_cases.py). Forwards within
atol 2e-4; decoded ids equal wherever JAX's top-2 margin exceeds twice the
measured step-output distance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.rec import ocr_transformer as jocr
from fudanocr_tpu.models.rec.oictr import OICTR as JaxOICTR
from fudanocr_tpu_torch.models.rec import ccr_clip, ocr_transformer
from fudanocr_tpu_torch.models.rec.oictr import OICTR
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)
from torch_ctr_cases import (ATOL, CLIP, CLIP_VISION, IDS, OICTR as OI,
                             SLD, check_ids, init)
from torch_threads import one_torch_thread  # noqa: F401

B, L = 2, 8


def _images(h, w, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, h, w, 3)).astype(np.float32)


def _tokens(vocab, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(
        np.int32)


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-3, atol=ATOL, err_msg=name)


def _ocr_pair(cfg, h, w):
    jm = jocr.OCRTransformer(**cfg)
    v = init(jm, np.zeros((B, h, w, 3), np.float32),
             np.zeros((B, L), np.int32))
    m = load_jax_variables(ocr_transformer.OCRTransformer(**cfg),
                           "ocr_transformer", v,
                           **({"layers": cfg["layers"]} if "layers" in cfg
                              else {"encoder_preset":
                                    cfg["encoder_preset"]}))
    return jm, v, m


@pytest.fixture(scope="module")
def sld_pair():
    return _ocr_pair(SLD, 32, 32)


@pytest.fixture(scope="module")
def ids_pair():
    return _ocr_pair(IDS, 32, 32)


@pytest.fixture(scope="module")
def oictr_pair():
    jm = JaxOICTR(**OI)
    v = init(jm, np.zeros((B, 32, 64, 3), np.float32),
             np.zeros((B, L), np.int32))
    m = load_jax_variables(OICTR(image_size=(32, 64), **OI), "oictr", v)
    return jm, v, m


@pytest.mark.parametrize("which", ["sld", "ids"])
def test_ocr_transformer_variants_match_jax(which, sld_pair, ids_pair):
    """SLD (stem pool only, narrow encoder at width_div 8) and CCR-CLIP
    stage 2 (the wide "image_ids" encoder, a 48-wide embedding
    generator)."""
    jm, v, m = sld_pair if which == "sld" else ids_pair
    x, t = _images(32, 32), _tokens(7 if which == "sld" else 38)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t).long())
    tokens = 16 * 16 if which == "sld" else 2 * 2
    assert got["conv"].shape[1] == tokens
    assert got["pred"].shape[-1] == (7 if which == "sld" else 48)
    for k in ("conv", "hidden", "pred", "map"):
        _close(got[k], want[k], k)


def test_oictr_matches_jax(oictr_pair):
    """Every output: logits, map, memory, char maps, direction branch and
    the raw reconstructions (the transposed convs)."""
    jm, v, m = oictr_pair
    x, t = _images(32, 64), _tokens(38)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got["raw_imgs"].shape == (B * L, 32, 32, 3)
    assert got["char_maps"].shape == (B, L, 64, 4)
    for k in want:
        _close(got[k], want[k], k)
    swap = np.random.default_rng(3).permutation(B * L)
    cm = np.array(want["char_maps"]).reshape(B * L, 64, 4)
    df = np.repeat(np.asarray(want["direction_feat"]), L, 0)[swap]
    want_new = jm.apply(v, jnp.asarray(cm), jnp.asarray(df),
                        method=jm.reconstruct)
    with torch.no_grad():
        got_new = m.reconstruct(torch.from_numpy(cm), torch.from_numpy(df))
    _close(got_new, want_new, "reconstruct")


@pytest.mark.parametrize("porter,build,kw", [
    ("ocr_transformer", lambda: ocr_transformer.OCRTransformer(**IDS),
     {"encoder_preset": "image_ids"}),
    ("oictr", lambda: OICTR(image_size=(32, 64), **OI), {}),
    ("ccr_clip", lambda: ccr_clip.CCRCLIP(vision_layers=CLIP_VISION, **CLIP),
     {"layers": CLIP_VISION, "transformer_layers": 2}),
])
def test_porters_round_trip(porter, build, kw):
    """A module's weights through its porter to the JAX layout and back
    are the same bits (each porter only moves elements)."""
    torch.manual_seed(0)
    m = build()
    v = to_jax_variables(m, porter, **kw)
    back = load_jax_variables(build(), porter, v, **kw)
    for k, t in m.state_dict().items():
        assert torch.equal(t, back.state_dict()[k]), k


def _decode_scores(jm, v, m, x, ids, gallery=None):
    """Each package's step outputs on the buffer [0, ids...] (JAX's own
    decode: position i's output is what its argmax read at step i)."""
    buf = np.concatenate([np.zeros((B, 1), np.int32),
                          np.asarray(ids, np.int32)], 1)
    mem = jm.apply(v, jnp.asarray(x), method=jm.encode)
    want, _, _ = jm.apply(v, mem, jnp.asarray(buf), method=jm.decode_step)
    with torch.no_grad():
        got, _, _ = m.decode_step(m.encode(torch.from_numpy(x)),
                                  torch.from_numpy(buf).long())
    want, got = np.asarray(want)[:, :-1], got.numpy()[:, :-1]
    if gallery is not None:
        unit = lambda e: e / np.maximum(np.linalg.norm(e, axis=-1,
                                                       keepdims=True), 1e-8)
        want, got = unit(want) @ gallery.T, unit(got) @ gallery.T
    return got, want


@pytest.mark.parametrize("which", ["sld", "oictr"])
def test_greedy_decode_matches_jax(which, sld_pair, oictr_pair):
    jm, v, m = sld_pair if which == "sld" else oictr_pair
    x = _images(32, 32 if which == "sld" else 64, seed=5)
    want = jocr.greedy_decode(jm, v, jnp.asarray(x), 6)
    got = ocr_transformer.greedy_decode(m, torch.from_numpy(x), 6)
    assert got.shape == (B, 6) and got.dtype == torch.int64
    err, _ = check_ids(got.numpy(), want,
                       *_decode_scores(jm, v, m, x, want))
    assert err < 1e-4


def test_greedy_decode_gallery_matches_jax(ids_pair):
    jm, v, m = ids_pair
    x = _images(32, 32, seed=6)
    gallery = np.random.default_rng(7).standard_normal((38, 48)).astype(
        np.float32)
    gallery[0] = 0.0
    want = jocr.greedy_decode_gallery(jm, v, jnp.asarray(x),
                                      jnp.asarray(gallery), 6)
    got = ocr_transformer.greedy_decode_gallery(
        m, torch.from_numpy(x), torch.from_numpy(gallery), 6)
    err, _ = check_ids(got.numpy(), want,
                       *_decode_scores(jm, v, m, x, want, gallery))
    assert err < 1e-4
