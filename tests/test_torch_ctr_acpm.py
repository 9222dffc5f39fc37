"""ACPM in the port against the JAX package on the CPU: the model
(models/rec/acpm.py) with each encoder, the STN and the CE radical
counter; its greedy decode; `port_acpm`; the profile matching
(eval/profile_matching.py); and `apps.acpm.train.main` (the training
step: tests/test_torch_ctr_acpm_step.py).

The same seeded numpy inputs, the same random weights moved by the port's
porter (`load_jax_variables(m, "acpm", v)`). The ResNet encoder runs at the
JAX package's smoke sizes (tests/test_ctr_variants.py: blocks (1, 1, 1, 1),
widths / 8, d_model 128); JAX's VGG and DenseNet take no width knob and run
at their own widths. Forwards within atol 2e-4; decoded ids by the top-2
margin rule (tests/torch_ctr_cases.py)."""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.rec.acpm import ACPM as JaxACPM
from fudanocr_tpu.models.rec.ocr_transformer import greedy_decode as jgreedy
from fudanocr_tpu_torch.apps.acpm import train as app
from fudanocr_tpu_torch.core.config import merge_cli_overrides
from fudanocr_tpu_torch.data.codecs import SequenceCodec
from fudanocr_tpu_torch.models.rec.acpm import ACPM
from fudanocr_tpu_torch.models.rec.ocr_transformer import greedy_decode
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)
from torch_ctr_cases import ATOL, check_ids, leaves, randomize
from torch_threads import one_torch_thread  # noqa: F401

B, L = 2, 8
SMALL = dict(encoder_layers=(1, 1, 1, 1), encoder_width_div=8, d_model=128)
CFG = merge_cli_overrides(app.DEFAULT_CONFIG, ["max_len=8"])
CHARSET, TABLE, R_NUM, S_NUM, S_LEN = app.build_profiles(CFG)
RADSET = sorted({r for v in TABLE.values() for r in v})
VOCAB = len(RADSET) + 2


def _images(seed, b=B):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, 32, 32, 3)).astype(np.float32)


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, L)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_model(encoder="resnet", stn=False, rn_loss="L1", bf16=False):
    """A JAX ACPM (compute dtype bf16 when `bf16`) and random variables:
    every leaf is drawn (`torch_ctr_cases.randomize`), so only the shapes
    of an init are needed. Cached: the tests share models."""
    kw = dict(vocab=VOCAB, encoder=encoder, stn=stn, rn_loss=rn_loss,
              **(SMALL if encoder == "resnet" else {"d_model": 128}))
    jm = JaxACPM(**kw, dtype=jnp.bfloat16 if bf16 else None)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((B, 32, 32, 3)),
                            jnp.zeros((B, L), jnp.int32))
    v = randomize(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes),
        np.random.default_rng(0))
    return jm, v, kw


def _pair(encoder="resnet", stn=False, rn_loss="L1", dtype=torch.float32):
    """`_jax_model` and the port's ACPM with the same weights, computing
    in `dtype` (float64: parameters too)."""
    jm, v, kw = _jax_model(encoder, stn, rn_loss, dtype == torch.bfloat16)
    m = ACPM(**kw, dtype=dtype)
    return jm, v, load_jax_variables(
        m.double() if dtype == torch.float64 else m, "acpm", v)


CASES = [("resnet", False, "L1"), ("resnet", True, "CE"),
         ("vgg", False, "L1"), ("densenet", False, "CE")]


@pytest.mark.parametrize("encoder,stn,rn_loss", CASES)
def test_acpm_forward_matches_jax(encoder, stn, rn_loss):
    """Every output: logits, map, memory, decoder output, the radical
    count (a softmax in CE mode) and the stroke heads."""
    jm, v, m = _pair(encoder, stn, rn_loss)
    x, t = _images(1), _tokens(2)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.keys() == want.keys()
    assert got["r_num"].shape == ((B,) if rn_loss == "L1" else (B, 11))
    assert got["conv"].shape[1] == {"resnet": 256, "vgg": 64,
                                    "densenet": 16}[encoder]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=ATOL, err_msg=k)
    if stn:
        want_r = jax.jit(functools.partial(jm.apply, method=jm.rectify))(
            v, jnp.asarray(x))
        with torch.no_grad():
            got_r = m.rectify(torch.from_numpy(x))
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                                   rtol=1e-3, atol=ATOL)


def test_acpm_greedy_decode_matches_jax():
    """The port's `greedy_decode` takes ACPM unchanged."""
    jm, v, m = _pair()
    x = _images(5)
    want = jgreedy(jm, v, jnp.asarray(x), 6)
    got = greedy_decode(m, torch.from_numpy(x), 6)
    buf = np.concatenate([np.zeros((B, 1), np.int32),
                          np.asarray(want, np.int32)], 1)
    ws, _, _ = jax.jit(lambda v, x, t: jm.apply(
        v, jm.apply(v, x, method=jm.encode), t, method=jm.decode_step))(
            v, jnp.asarray(x), jnp.asarray(buf))
    with torch.no_grad():
        gs, _, _ = m.decode_step(m.encode(torch.from_numpy(x)),
                                 torch.from_numpy(buf).long())
    err, _ = check_ids(got.numpy(), want, gs.numpy()[:, :-1],
                       np.asarray(ws)[:, :-1])
    assert err < 1e-4


@pytest.mark.parametrize("encoder,stn,rn_loss", CASES)
def test_port_acpm_round_trips(encoder, stn, rn_loss):
    """JAX variables -> the port -> JAX are the same bits, and the port's
    `port_acpm` reads a state_dict as JAX's does where JAX's covers it
    (the ResNet at the reference's depth, without an STN)."""
    from fudanocr_tpu.utils.torch_port import port_acpm as jax_port_acpm

    _, v, m = _pair(encoder, stn, rn_loss)
    back = to_jax_variables(m, "acpm")
    want, got = leaves(v), leaves(back)
    assert got.keys() == want.keys()
    for k, a in want.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k
    if encoder == "resnet" and not stn:
        torch.manual_seed(0)
        full = ACPM(VOCAB, encoder_width_div=8, d_model=128)
        sd = {k: t.numpy() for k, t in full.state_dict().items()}
        ours = leaves(to_jax_variables(full, "acpm"))
        theirs = leaves(jax_port_acpm(sd))
        assert ours.keys() == theirs.keys()
        for k, a in theirs.items():
            assert np.array_equal(ours[k], a), k


def test_profile_matching_matches_jax():
    from fudanocr_tpu.eval import profile_matching as jpm
    from fudanocr_tpu_torch.eval import profile_matching as pm

    rng = np.random.default_rng(11)
    legal = ["".join(rng.choice(list("abcdef"), rng.integers(2, 6)))
             for _ in range(40)]
    n = len(legal)
    feats = {i: rng.standard_normal((16, 8)).astype(np.float32)
             for i in range(n)}
    r = list(rng.integers(2, 6, n).astype(float))
    sn = [rng.integers(1, 5, 4).astype(np.float32) for _ in range(n)]
    sl = [rng.uniform(0, 4, 4).astype(np.float32) for _ in range(n)]
    sl[3][0], sl[5][2] = 0.0, 0.0    # the ratio rules' zero guards
    picks = 0
    for trial in range(30):
        pred = "".join(rng.choice(list("abcdefg"), rng.integers(0, 7)))
        level = int(trial % 3)
        cands = pm.get_candidates(pred, legal, level)
        assert cands == jpm.get_candidates(pred, legal, level)
        args = (cands, rng.standard_normal((16, 8)).astype(np.float32),
                float(rng.uniform(1, 6)), rng.uniform(1, 5, 4),
                rng.uniform(0, 4, 4), feats, r, sn, sl)
        pick = pm.select_candidate(*args)
        assert pick == jpm.select_candidate(*args)
        picks += len(cands) > 1
    assert picks >= 10


def _host_batch(seed, b=4):
    """A seeded batch through the port's `host_batch` (the port's print
    templates: both packages get the same arrays)."""
    from fudanocr_tpu_torch.apps.oictr.train import render_char_templates

    rng = np.random.default_rng(seed)
    labels = [CHARSET[i] for i in rng.integers(0, len(CHARSET), b)]
    fake = types.SimpleNamespace(
        cfg=CFG, templates=render_char_templates(CHARSET, 32),
        codec=SequenceCodec(["<"] + RADSET + ["$"], TABLE, terminator="$"),
        r_num=R_NUM, s_num=S_NUM, s_len=S_LEN)
    return app.ACPMTrainer.host_batch(fake, _images(seed + 1, b), labels)


SMALL_OPTS = ["encoder_layers=1,1,1,1", "d_model=128", "encoder_width_div=8",
              "max_len=6", "val_frequency=1000000"]


def test_acpm_main(tmp_path):
    """`main --device cpu` on a synthetic set whose test set holds two
    whole batches (16 // 4 = 8 samples at batch 4): `best/` loads into a
    fresh model and its evaluation gives the run's accuracy."""
    from fudanocr_tpu_torch.core.checkpoint import load_model_state

    ckpt = str(tmp_path / "acpm")
    opts = SMALL_OPTS + ["batch=4", "synthetic_samples=16",
                         f"ckpt_dir={ckpt}"]
    res = app.main(["--device", "cpu", "--options", "epoch=1", *opts])
    assert 0.0 <= res["acc"] <= 1.0
    trainer = app.ACPMTrainer(merge_cli_overrides(app.DEFAULT_CONFIG, opts),
                              "cpu")
    assert len(list(trainer.test_data.batches(4))) == 2
    trainer.model.load_state_dict(load_model_state(
        os.path.join(ckpt, "best")))
    assert trainer.optimizer.count == 0
    assert trainer.evaluate(0) == res


def test_acpm_main_default_config_evaluates_nothing(tmp_path):
    """JAX's quirk, kept (ROADMAP C31): at the default synthetic_samples
    64 and batch 32 the test set holds 16 samples, no whole batch, so the
    evaluation decodes nothing and reports acc 0."""
    cfg = merge_cli_overrides(app.DEFAULT_CONFIG, SMALL_OPTS + [
        f"ckpt_dir={tmp_path}"])
    trainer = app.ACPMTrainer(cfg, "cpu")
    assert len(trainer.test_data) == 16 and cfg.batch == 32
    assert list(trainer.test_data.batches(cfg.batch)) == []
    assert trainer.evaluate(0) == {"acc": 0.0}
    assert os.path.isdir(os.path.join(tmp_path, "best"))


def test_acpm_main_defaults_to_the_card(tmp_path):
    """Without --device the app asks for CUDA, and a missing card
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--options", f"ckpt_dir={tmp_path}"])
