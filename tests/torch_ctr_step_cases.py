"""One train step of each CTR trainer of the port against the JAX
package's, shared by tests/test_torch_ctr_steps.py (float64),
tests/test_torch_ctr_steps_fp32.py (float32) and
tests/test_torch_ctr_clip.py: the SLD step (train/ctr.py, the masked token
CE), CCR-CLIP stage 2's (the JAX app's own gallery loss, captured from its
`main`), OI-CTR's (apps/oictr/train.py: CE, reconstruction,
direction-swap and direction losses) and CCR-CLIP stage 1's
(apps/ccr_clip/pretrain.py). The same seeded numpy batch, the same random
weights (tests/torch_ctr_cases.py sizes), dropout off on both sides (the
`no_dropout` fixture for JAX, `no_port_dropout` for the port). The JAX
step runs through an optax transformation that returns its gradients; the
port's through an optimizer that moves nothing. Each case checks the
training bar (`torch_ctr_cases.check_step`) over the gradient leaves
`hold` picks (all by default).

In float64 JAX runs under `jax.enable_x64` and the port's modules are
`.double()`, with the fp32 islands each package keeps (the decoder's
LayerNorm and attention softmax, the CE)."""

import contextlib
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.train.state import TrainState
from torch_ctr_cases import (CLIP, CLIP_VISION, IDS, OICTR as OI, SLD,
                             capture_grads_tx, check_step, init,
                             no_port_dropout, no_update, small_clip_vision)

B, L = 4, 8
CHARS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def outside_encoder(key):
    """JAX tree keys of the leaves outside the encoder: their gradients
    reach none of its ReLUs or pools on their way back."""
    return not key.startswith("['encoder']")


def images(h, w, seed=1, b=B):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, h, w, 3)).astype(np.float32)


def labels(seed, max_chars):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(CHARS), rng.integers(1, max_chars + 1)))
            for _ in range(B)]


def _cast(a, x64):
    a = np.asarray(a)
    return a.astype(np.float64) if x64 and a.dtype == np.float32 else a


def _batches(imgs, codec, text, x64):
    ti, tg, ln = codec.encode(text, L)
    host = {"image": _cast(imgs, x64), "text_input": ti, "text_gt": tg,
            "lengths": ln}
    return host, {k: torch.from_numpy(v) if v.dtype.kind == "f"
                  else torch.from_numpy(v).long() for k, v in host.items()}


def _precision(x64):
    return jax.enable_x64(True) if x64 else contextlib.nullcontext()


def _jax_step(step, jm_vars, batch, *args, x64, compiler_options=None):
    """One JAX step from `jm_vars` on the host `batch`, in float64 when
    `x64`, compiled with XLA's `compiler_options`."""
    with _precision(x64):
        v = jax.tree_util.tree_map(lambda a: _cast(a, x64), jm_vars)
        state = TrainState.create(v["params"], v["batch_stats"],
                                  capture_grads_tx())
        return jax.jit(step, compiler_options=compiler_options)(
            state, {k: jnp.asarray(a) for k, a in batch.items()}, *args)


def _ocr_pair(cfg, x64, **kw):
    from fudanocr_tpu.models.rec import ocr_transformer as jocr
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.utils.weights import load_jax_variables

    jm = jocr.OCRTransformer(**cfg)
    v = init(jm, np.zeros((B, 32, 32, 3), np.float32),
             np.zeros((B, L), np.int32))
    m = (OCRTransformer(**cfg, dtype=torch.float64).double() if x64
         else OCRTransformer(**cfg))
    m = load_jax_variables(m, "ocr_transformer", v, **kw)
    return jm, v, no_port_dropout(m)


def sld_step(x64, hold=None):
    """Stroke-mode SLD: the synthetic table's stroke strings, token CE."""
    from fudanocr_tpu.core.mesh import make_mesh_for_batch
    from fudanocr_tpu.train import ctr as jctr
    from fudanocr_tpu_torch.apps.sld.train import (STROKE_ALPHABET,
                                                   synthetic_stroke_table)
    from fudanocr_tpu_torch.data.codecs import SequenceCodec
    from fudanocr_tpu_torch.train.ctr import make_ctr_train_step

    jm, v, m = _ocr_pair(SLD, x64, layers=SLD["layers"])
    codec = SequenceCodec(STROKE_ALPHABET, synthetic_stroke_table(),
                          terminator="$")
    jb, tb = _batches(images(32, 32), codec, labels(2, 1), x64)
    step = jctr.make_ctr_train_step(jm, make_mesh_for_batch(B),
                                    wrap_jit=False)
    state, want = _jax_step(step, v, jb, jax.random.PRNGKey(0), x64=x64)
    got = make_ctr_train_step(m, no_update(m))(tb)
    worst = check_step(m, "ocr_transformer", state, got, want,
                       {"layers": SLD["layers"]}, hold=hold)
    print(f"sld step: loss {float(got)} vs {float(want)}, worst grad "
          f"rel {worst:.2e}")


def _jax_gallery_loss(monkeypatch, gallery):
    """The loss JAX's apps.ccr_clip.train.main builds over `gallery`."""
    from fudanocr_tpu.apps.ccr_clip import train as japp
    from fudanocr_tpu.train import ctr as jctr

    captured = {}

    class Stop(Exception):
        pass

    class Capture:
        def __init__(self, *a, **kw):
            captured.update(kw)
            raise Stop

    monkeypatch.setattr(japp, "build_gallery",
                        lambda *a: jnp.asarray(gallery))
    monkeypatch.setattr(jctr, "CTRTrainer", Capture)
    with pytest.raises(Stop):
        japp.main(["--options", "synthetic_samples=8"])
    return captured["loss_fn"]


def stage2_step(monkeypatch, x64, hold=None):
    """The gallery loss (cosine CE minus 0.001 x MSE to the target rows)
    over a gallery with JAX's zero and ones rows."""
    from fudanocr_tpu.core.mesh import make_mesh_for_batch
    from fudanocr_tpu.train import ctr as jctr
    from fudanocr_tpu_torch.apps.ccr_clip import train as ccr2
    from fudanocr_tpu_torch.data.codecs import SequenceCodec
    from fudanocr_tpu_torch.train.ctr import make_ctr_train_step

    jm, v, m = _ocr_pair(IDS, x64, encoder_preset="image_ids")
    rng = np.random.default_rng(3)
    gallery = rng.standard_normal((IDS["vocab"], IDS["out_dim"])).astype(
        np.float32)
    gallery[0], gallery[-1] = 0.0, 1.0
    codec = SequenceCodec(["<"] + list(CHARS) + ["$"], None, terminator="$")
    jb, tb = _batches(images(32, 32, 4), codec, labels(5, L - 1), x64)
    step = jctr.make_ctr_train_step(jm, make_mesh_for_batch(B),
                                    _jax_gallery_loss(monkeypatch, gallery),
                                    wrap_jit=False)
    state, want = _jax_step(step, v, jb, jax.random.PRNGKey(0), x64=x64)
    got = make_ctr_train_step(m, no_update(m), ccr2.gallery_loss(
        torch.from_numpy(gallery)))(tb)
    worst = check_step(m, "ocr_transformer", state, got, want,
                       {"encoder_preset": "image_ids"}, hold=hold)
    print(f"stage-2 step: loss {float(got)} vs {float(want)}, worst grad "
          f"rel {worst:.2e}")


def oictr_fake(codec):
    """What the trainers' batch builders read of their `self`."""
    from fudanocr_tpu_torch.apps.oictr import train as oictr_app

    return types.SimpleNamespace(
        codec=codec, cfg=types.SimpleNamespace(max_len=L),
        templates=oictr_app.render_char_templates(list(CHARS)))


def oictr_step(x64, hold=None):
    """Vertical and horizontal samples, so the swap pairs opposite
    orientations; all four loss terms."""
    from fudanocr_tpu.apps.oictr.train import OICTRTrainer as JaxTrainer
    from fudanocr_tpu.models.rec.oictr import OICTR as JaxOICTR
    from fudanocr_tpu_torch.apps.oictr import train as oictr_app
    from fudanocr_tpu_torch.data.codecs import SequenceCodec
    from fudanocr_tpu_torch.models.rec.oictr import OICTR
    from fudanocr_tpu_torch.utils.weights import load_jax_variables

    jm = JaxOICTR(**OI)
    v = init(jm, np.zeros((B, 32, 64, 3), np.float32),
             np.zeros((B, L), np.int32))
    m = OICTR(image_size=(32, 64), **OI)
    m = no_port_dropout(load_jax_variables(m.double() if x64 else m,
                                           "oictr", v))
    codec = SequenceCodec(["<"] + list(CHARS) + ["$"], None, terminator="$")
    host = oictr_app.OICTRTrainer.host_batch(
        oictr_fake(codec), images(32, 64, 7), labels(8, L - 1),
        np.array([1, 0, 0, 1]))
    host = {k: _cast(a, x64) for k, a in host.items()}
    step = JaxTrainer._make_train_step(types.SimpleNamespace(model=jm))
    state, want = _jax_step(step.__wrapped__, v, host,
                            jax.random.PRNGKey(0), x64=x64)
    got = oictr_app.make_oictr_train_step(m, no_update(m))(
        {k: torch.from_numpy(a) for k, a in host.items()})
    worst = check_step(m, "oictr", state, got, want, hold=hold)
    print(f"oictr step: loss {float(got)} vs {float(want)}, worst grad "
          f"rel {worst:.2e}")


def clip_jax(batch=2):
    """JAX's CCRCLIP at the CLIP sizes with CLIP_VISION blocks and its
    random variables."""
    from fudanocr_tpu.models.rec import ccr_clip as jccr

    mp = pytest.MonkeyPatch()
    small_clip_vision(mp)
    try:
        jm = jccr.CCRCLIP(**CLIP)
        v = init(jm, np.zeros((batch, 32, 32, 3), np.float32),
                 np.zeros((batch, CLIP["context_length"]), np.int32))
    finally:
        mp.undo()
    return jm, v


def clip_text(seed=4, b=2):
    """Radical ids with the terminator (the largest id) inside, junk
    after it."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, CLIP["vocab_size"] - 1,
                     (b, CLIP["context_length"])).astype(np.int32)
    t[0, 3], t[1, 5] = CLIP["vocab_size"] - 1, CLIP["vocab_size"] - 1
    t[0, 4:] = 0
    return t


def clip_pretrain_step(monkeypatch, jm, v, x64, hold=None):
    """CCR-CLIP stage 1's step (apps/ccr_clip/pretrain.py) against JAX's
    CLIPPretrainer step on a batch with duplicate labels: the symmetric CE
    with first-occurrence targets, gradients through both towers and
    exp(logit_scale), the image tower's BatchNorm statistics. `jm`, `v`:
    `clip_jax()`."""
    from fudanocr_tpu.apps.ccr_clip.pretrain import CLIPPretrainer
    from fudanocr_tpu_torch.apps.ccr_clip.pretrain import make_clip_train_step
    from fudanocr_tpu_torch.losses.clip_loss import first_occurrence_targets
    from fudanocr_tpu_torch.models.rec import ccr_clip
    from fudanocr_tpu_torch.utils.weights import load_jax_variables

    small_clip_vision(monkeypatch)
    fdt = np.float64 if x64 else np.float32
    m = ccr_clip.CCRCLIP(vision_layers=CLIP_VISION, **CLIP)
    m = load_jax_variables(
        m.double() if x64 else m, "ccr_clip", v, layers=CLIP_VISION,
        transformer_layers=CLIP["transformer_layers"])
    x = images(32, 32, 8, b=2).astype(fdt)
    x = np.concatenate([x, x[:1]])
    t = np.concatenate([clip_text(9), clip_text(9)[:1]])
    targets = first_occurrence_targets(["p", "q", "p"])
    step = CLIPPretrainer._make_train_step(
        type("Fake", (), {"model": jm})())
    with _precision(x64):
        vx = jax.tree_util.tree_map(lambda a: np.asarray(a, fdt), v)
        state = TrainState.create(vx["params"], vx["batch_stats"],
                                  capture_grads_tx())
        state, want = jax.jit(step.__wrapped__)(
            state, jnp.asarray(x), jnp.asarray(t), jnp.asarray(targets))
    got = make_clip_train_step(m, no_update(m))(
        torch.from_numpy(x), torch.from_numpy(t).long(),
        torch.from_numpy(targets))
    worst = check_step(m, "ccr_clip", state, got, want,
                       {"layers": CLIP_VISION,
                        "transformer_layers": CLIP["transformer_layers"]},
                       hold=hold)
    print(f"clip step: loss {float(got)} vs {float(want)}, worst grad rel "
          f"{worst:.2e}")
