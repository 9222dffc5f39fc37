"""ASTER's attention head, its label codec and the vocabulary maps of the
port (fudanocr_tpu_torch/models/rec/aster_head.py, eval/attention_codec.py,
eval/labelmaps.py) against the JAX package on the CPU, JAX's seeded
variables carried across by the port's `aster_head` porter:

* the teacher-forced logits at atol 2e-4, the greedy ids equal and their
  probabilities at 2e-4, beam search's ids equal and its scores at 2e-4,
  for beam widths 1, 3 and 5, at JAX's test size and at a wider one;
* a head whose logits all tie (fc zeroed): JAX's tie rule (the lower flat
  beam x class index first, greedy's first maximum) and its length rule
  (a beam that emits eos keeps its score and emits eos again, and wins);
* the codec's encode / decode and the vocabularies, equal to JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.rec.aster_head import \
    ASTERAttentionHead as JaxHead
from fudanocr_tpu_torch.models.rec.aster_head import ASTERAttentionHead
from fudanocr_tpu_torch.utils.weights import load_jax_variables
from torch_ctr_cases import randomize
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4
SIZES = {"jax_test": dict(num_classes=12, in_planes=16, s_dim=16,
                          att_dim=16, max_len=6),
         "wide": dict(num_classes=37, in_planes=64, s_dim=48, att_dim=32,
                      max_len=12)}
T = 10


@functools.lru_cache(maxsize=None)
def _case(size, tie=False):
    cfg = SIZES[size]
    jm = JaxHead(**cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, T, cfg["in_planes"])).astype(np.float32)
    tgt = rng.integers(0, cfg["num_classes"],
                       (3, cfg["max_len"])).astype(np.int32)
    v = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(tgt)), rng)
    if tie:
        p = v["params"]
        p["fc_w"] = np.zeros_like(p["fc_w"])
        p["fc_b"] = np.zeros_like(p["fc_b"])
    torch.manual_seed(3)
    m = load_jax_variables(ASTERAttentionHead(**cfg), "aster_head", v)
    # JAX's steps index the embedding table with traced ids
    return jm, jax.tree_util.tree_map(jnp.asarray, v), m, x, tgt


@pytest.mark.parametrize("size", sorted(SIZES))
def test_teacher_forced_and_greedy_match_jax(size):
    jm, v, m, x, tgt = _case(size)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(tgt))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=ATOL)
    ids, probs = jm.apply(v, jnp.asarray(x), method=jm.sample)
    got_ids, got_probs = m.sample(torch.from_numpy(x))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(probs),
                               rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("width", [1, 3, 5])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_beam_search_matches_jax(size, width):
    jm, v, m, x, _ = _case(size)
    eos = jm.num_classes - 1
    ids, scores = jm.apply(v, jnp.asarray(x), width, eos,
                           method=jm.beam_search)
    got_ids, got_scores = m.beam_search(torch.from_numpy(x), width, eos)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(scores),
                               rtol=1e-5, atol=ATOL)


def test_ties_and_finished_beams_follow_jax():
    jm, v, m, x, _ = _case("jax_test", tie=True)
    c = jm.num_classes
    ids, _ = m.sample(torch.from_numpy(x))
    assert (ids == 0).all()                     # the first maximum
    # eos 2 is among the first 5 classes: its beam ends at step 0 and keeps
    # log(1 / c) while every other beam adds log(1 / c) a step
    for eos in (2, c - 1):
        want_ids, want_s = jm.apply(v, jnp.asarray(x), 5, eos,
                                    method=jm.beam_search)
        got_ids, got_s = m.beam_search(torch.from_numpy(x), 5, eos)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-6)
    assert (got_ids[:, 0] == 0).all()           # eos c - 1 never ranks
    got_ids, got_s = m.beam_search(torch.from_numpy(x), 5, 2)
    assert (got_ids == 2).all()
    np.testing.assert_allclose(got_s.numpy(), -np.log(c), rtol=1e-6)


def test_attention_codec_and_labelmaps_match_jax():
    from fudanocr_tpu.eval import attention_codec as jc
    from fudanocr_tpu.eval import labelmaps as jl
    from fudanocr_tpu_torch.eval import attention_codec as pc
    from fudanocr_tpu_torch.eval import labelmaps as pl

    texts = ["Hello", "a1-b2", "", "x" * 30]
    for alphabet in (None, "a:b:c:$"):
        j, p = jc.AttentionLabelConverter(alphabet), \
            pc.AttentionLabelConverter(alphabet)
        assert p.num_classes == j.num_classes and p.eos == j.eos
        for got, want in zip(p.encode(texts, 12), j.encode(texts, 12)):
            np.testing.assert_array_equal(got, want)
        ids = p.encode(texts, 12)[0]
        assert p.decode_ids(ids) == j.decode_ids(ids)
    for voc in ("LOWERCASE", "ALLCASES", "ALLCASES_SYMBOLS"):
        v = pl.get_vocabulary(voc)
        assert v == jl.get_vocabulary(voc)
        assert pl.char2id(v) == jl.char2id(v)
        assert pl.id2char(v) == jl.id2char(v)
    with pytest.raises(KeyError):
        pl.get_vocabulary("KOREAN")
