"""The CTR slice's host pieces and optimizers against the JAX package on
the CPU: the radical codec (data/codecs.py), the Levenshtein rectifier
(eval/levenshtein.py), the recognition datasets (data/rec_dataset.py) on
LMDB stores JAX writes here with PIL, the synthetic character set and the
OI-CTR templates (equal outside the glyph boxes: the port draws its bitmap
font where JAX draws PIL's, ROADMAP C17), the LR schedules
(train/schedules.py, rel 1e-6 over three restarts) and the optimizers
(train/state.py `ctr_adadelta`, `clip_adam`: three updates against optax,
rel 1e-5)."""

import io
import random
import string

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image, ImageDraw

from fudanocr_tpu_torch.data import codecs, rec_dataset
from fudanocr_tpu_torch.data.glyphs import text_bbox
from fudanocr_tpu_torch.eval.levenshtein import (SequenceRectifier,
                                                 edit_distance)
from fudanocr_tpu_torch.train import schedules
from fudanocr_tpu_torch.train.state import clip_adam, ctr_adadelta


def test_radical_codec_matches_jax(tmp_path):
    """The seeded synthetic radical system draw for draw, and a table file
    with multi-char radicals and the colon's own line."""
    from fudanocr_tpu.data import codecs as jcodecs

    got, want = codecs.radical_codec(), jcodecs.radical_codec()
    assert got.alphabet == want.alphabet and got.terminator == "$"
    assert got.decomposition == want.decomposition
    labels = ["A", "Z9", "", "7Q", "?"]
    for a, b in zip(got.encode(labels, 12), want.encode(labels, 12)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    alpha, table = tmp_path / "alpha.txt", tmp_path / "dec.txt"
    alpha.write_text("口\n木\n⿰\n:\n", encoding="utf-8")
    table.write_text("林:⿰ 木 木\n:\n杏:⿱ 木 口\n", encoding="utf-8")
    assert (codecs.load_radical_table(str(table))
            == jcodecs.load_radical_table(str(table)))
    got = codecs.radical_codec(str(alpha), str(table))
    want = jcodecs.radical_codec(str(alpha), str(table))
    assert got.alphabet == want.alphabet
    for a, b in zip(got.encode(["林", ":杏"], 8), want.encode(["林", ":杏"],
                                                            8)):
        assert np.array_equal(a, b)


def test_rectifier_matches_jax():
    from fudanocr_tpu.eval import levenshtein as jlev

    rng = random.Random(3)
    legal = sorted({"".join(rng.choice("12345")
                            for _ in range(rng.randint(2, 6)))
                    for _ in range(40)})
    got, want = SequenceRectifier(legal), jlev.SequenceRectifier(legal)
    for _ in range(200):
        s = "".join(rng.choice("12345") for _ in range(rng.randint(0, 8)))
        assert got(s) == want(s)
        assert edit_distance(s, legal[0]) == jlev.edit_distance(s, legal[0])
    assert edit_distance("kitten", "sitting") == 3


def test_synthetic_stroke_table_and_str_q2b_match_jax():
    from fudanocr_tpu.apps.sld.train import DEFAULT_CONFIG, \
        build_codec_and_data
    from fudanocr_tpu.data import rec_dataset as jrec
    from fudanocr_tpu_torch.apps.sld.train import synthetic_stroke_table

    codec = build_codec_and_data(DEFAULT_CONFIG)[0]
    assert synthetic_stroke_table() == codec.decomposition
    s = "ＡＢＣ\u3000１２！ｚ～中"
    assert rec_dataset.str_q2b(s) == jrec.str_q2b(s)
    for n, b in ((37, 8), (64, 32), (5, 5)):
        assert (rec_dataset.random_sequential_order(n, b, 4)
                == jrec.random_sequential_order(n, b, 4))


def _jpeg(img, quality=92):
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _png(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def char_store(tmp_path_factory):
    """A store JAX's LMDBWriter writes: JPEG and PNG crops (RGB and gray),
    wide and tall (vertical under OI-CTR's rule), 7 items."""
    from fudanocr_tpu.data.lmdb_store import LMDBWriter

    rng = np.random.default_rng(2)
    path = str(tmp_path_factory.mktemp("rec") / "chars")
    w = LMDBWriter(path)
    sizes = [(40, 30), (20, 50), (64, 64), (17, 60), (90, 20), (33, 49),
             (50, 33)]
    for i, (wd, ht) in enumerate(sizes, 1):
        arr = rng.integers(0, 256, (ht, wd, 3), dtype=np.uint8)
        img = Image.fromarray(arr)
        if i % 3 == 0:
            img = img.convert("L")
        w.put(b"image-%09d" % i, _png(img) if i % 2 else _jpeg(img))
        w.put(b"label-%09d" % i, "ABC"[i % 3].encode() * (i % 4 + 1))
    w.put(b"num-samples", str(len(sizes)).encode())
    w.write()
    return path


@pytest.mark.parametrize("orientation", [False, True])
def test_lmdb_datasets_match_jax(char_store, orientation):
    """Items and batches byte-equal to JAX's (PIL decode, BICUBIC /
    ROTATE_90 + BILINEAR)."""
    from fudanocr_tpu.data import rec_dataset as jrec

    cls = "OrientationLMDBDataset" if orientation else "RecLMDBDataset"
    got = getattr(rec_dataset, cls)(char_store, (32, 48))
    want = getattr(jrec, cls)(char_store, (32, 48))
    assert len(got) == len(want) == 7
    vertical = 0
    for i in range(7):
        g, w = got[i], want[i]
        assert g[0].dtype == np.float32 and np.array_equal(g[0], w[0])
        assert g[1:] == w[1:]
        vertical += orientation and g[2]
    assert not orientation or 0 < vertical < 7
    for gb, wb in zip(got.batches(3), want.batches(3)):
        for a, b in zip(gb, wb):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_lmdb_dataset_alphabet_filter_matches_jax(char_store):
    from fudanocr_tpu.data import rec_dataset as jrec

    got = list(rec_dataset.RecLMDBDataset(char_store, (32, 32),
                                          "AB").batches(3, shuffle=True))
    want = list(jrec.RecLMDBDataset(char_store, (32, 32),
                                    "AB").batches(3, shuffle=True))
    assert len(got) == len(want) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gl == wl and np.array_equal(gi, wi)


def _keep_outside(shape, boxes, scale=1, margin=0):
    """Output pixels no box (in source pixels, right/bottom exclusive)
    reaches: each box divided by `scale`, widened by `margin`."""
    keep = np.ones(shape, bool)
    for x0, y0, x1, y1 in boxes:
        keep[max(y0 // scale - margin, 0):-(-y1 // scale) + margin,
             max(x0 // scale - margin, 0):-(-x1 // scale) + margin] = False
    return keep


def test_synthetic_char_dataset_matches_jax():
    """Labels and every draw are JAX's: PIL's text at the port's origin
    rebuilds JAX's item exactly; the port's item equals JAX's outside the
    two glyph boxes widened by the bicubic shrink's support (2 output
    pixels)."""
    from fudanocr_tpu.data import rec_dataset as jrec

    for seed, size in ((0, (32, 32)), (1, (32, 128))):
        got = rec_dataset.SyntheticCharDataset(num_samples=6,
                                               image_size=size, seed=seed)
        want = jrec.SyntheticCharDataset(num_samples=6, image_size=size,
                                         seed=seed)
        assert got.labels == want.labels
        h, w = size
        draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
        for i in range(6):
            (g, gl), (wa, wl) = got[i], want[i]
            assert gl == wl and g.shape == wa.shape == (h, w, 3)
            xy, rng = got.draws(i)
            img = Image.new("RGB", (w * 2, h * 2), (255, 255, 255))
            ImageDraw.Draw(img).text(xy, gl, fill=(0, 0, 0))
            img = img.resize((w, h), Image.BICUBIC)
            rebuilt = np.asarray(img, np.float32) / 127.5 - 1.0
            rebuilt += rng.normal(0, 0.02, rebuilt.shape).astype(np.float32)
            assert np.array_equal(rebuilt, wa)
            keep = _keep_outside((h, w), [draw.textbbox(xy, gl),
                                          text_bbox(xy, gl)], 2, 2)
            assert keep.mean() > 0.6
            assert np.array_equal(g[keep], wa[keep])
            assert not np.array_equal(g, wa)   # the glyphs do differ


def test_char_templates_and_swap_match_jax():
    from fudanocr_tpu.apps.oictr import train as joictr
    from fudanocr_tpu_torch.apps.oictr import train as oictr

    chars = string.ascii_uppercase + string.digits
    got = oictr.render_char_templates(chars)
    want = joictr.render_char_templates(chars)
    draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    for ch in chars:
        assert got[ch].dtype == np.float32 and got[ch].shape == (32, 32, 3)
        keep = _keep_outside((32, 32), [draw.textbbox((10, 10), ch),
                                        text_bbox((10, 10), ch)])
        assert np.array_equal(got[ch][keep], want[ch][keep]), ch
    rng = np.random.default_rng(0)
    for _ in range(20):
        is_v = rng.integers(0, 2, 12)
        valid = rng.integers(0, 2, 12)
        assert np.array_equal(oictr.swap_indices(is_v, valid),
                              joictr.swap_indices(is_v, valid))


@pytest.mark.parametrize("t_mult", [1, 2])
def test_cosine_warm_restarts_match_jax(t_mult):
    from fudanocr_tpu.train import schedules as jsch

    got = schedules.cosine_warm_restarts(0.7, 5, t_mult, 0.01)
    want = jsch.cosine_warm_restarts(0.7, 5, t_mult, 0.01)
    steps = 3 * 5 if t_mult == 1 else 5 + 10 + 20
    for step in range(steps + 2):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))


def test_step_decay_matches_jax():
    from fudanocr_tpu.train import schedules as jsch

    got = schedules.step_decay_after(1e-4, steps_per_epoch=3)
    want = jsch.step_decay_after(1e-4, steps_per_epoch=3)
    for step in range(3 * 20):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def _run_optimizers(make_port, tx, steps=3, seed=0):
    """Three updates of both on the same gradients, in float64 (so the
    comparison reads the update rule, not fp32 rounding of p + dp): each
    tensor's move within 1e-5 norm-relative."""
    import jax

    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s) for s in ((5, 3), (7,), (2, 2, 3))]
    grads = [[rng.standard_normal(p.shape) for p in params]
             for _ in range(steps)]
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params]
    opt = make_port(tparams)
    with jax.enable_x64(True):
        want = [jnp.asarray(p) for p in params]
        state = tx.init(want)
        for g in grads:
            upd, state = tx.update([jnp.asarray(a) for a in g], state, want)
            want = optax.apply_updates(want, upd)
            opt.zero_grad()
            for p, a in zip(tparams, g):
                p.grad = torch.from_numpy(a.copy())
            opt.step()
        want = [np.asarray(w) for w in want]
    for p, w, p0 in zip(tparams, want, params):
        move, want_move = p.detach().numpy() - p0, w - p0
        assert np.linalg.norm(want_move) > 1e-3
        assert (np.linalg.norm(move - want_move)
                <= 1e-5 * np.linalg.norm(want_move))


@pytest.mark.parametrize("decay", [0.0, 1e-4, 0.3])
def test_ctr_adadelta_matches_optax(decay):
    """optax chain(add_decayed_weights, adadelta(rho 0.9, eps 1e-6)) at a
    constant lr, and under OI-CTR's restart schedule (count from 0)."""
    tx = optax.adadelta(1.0, rho=0.9, eps=1e-6)
    if decay:
        tx = optax.chain(optax.add_decayed_weights(decay), tx)
    _run_optimizers(lambda ps: ctr_adadelta(ps, 1.0, decay), tx)
    from fudanocr_tpu.train.schedules import cosine_warm_restarts as jcos

    tx = optax.chain(optax.add_decayed_weights(1e-4), optax.adadelta(
        jcos(1.0, 2), rho=0.9, eps=1e-6))
    _run_optimizers(lambda ps: ctr_adadelta(
        ps, schedules.cosine_warm_restarts(1.0, 2), 1e-4), tx, seed=1)


def test_clip_adam_matches_optax():
    tx = optax.adam(1e-2, b1=0.9, b2=0.98, eps=1e-6)
    _run_optimizers(lambda ps: clip_adam(ps, 1e-2), tx)
