"""One training step of each CTR model in bf16 against the JAX package's
bf16 step on the CPU: SLD's (train/ctr.py, the masked token CE), OI-CTR's
(apps/oictr/train.py), CCR-CLIP stage 1's (apps/ccr_clip/pretrain.py) and
ACPM's (apps/acpm/train.py; stage 1 at a batch of 3 and ACPM in
tests/test_torch_ctr_bf16_clip_acpm_steps.py, stage 1 at 128 in
tests/test_torch_ctr_bf16_clip_witness.py), each model built with
`dtype=torch.bfloat16` against the JAX module with `dtype=jnp.bfloat16`,
from the same float32 weights, on the batches of
tests/torch_ctr_step_cases.py and tests/test_torch_ctr_acpm_step.py,
dropout off on both sides. JAX's steps are compiled with XLA's excess
precision off (JAX_ROUNDING), so that XLA:CPU rounds each op's bf16
result as torch does instead of keeping some fusions' intermediates in
float32. JAX's float32 step is the yardstick of what bf16 itself moves.

The bar (PERF.md section 2's bf16 training bar as it holds between the
packages), on the loss and per top-level module ("group": encoder,
decoder, generator, ...) on its gradients together and on its BatchNorm
statistics after the step. For each group, norm-relative to JAX's float32
step's f: ours = |port bf16 - JAX bf16|, ours32 = |port bf16 - f|, jaxs =
|JAX bf16 - f|, and the scale of each bf16 step's gradient along f
(<g, f> / <f, f>):
* the loss within 1e-2 relative of JAX's bf16 step's;
* every group: ours within QUIET_RATIO * jaxs (the port rounds where
  JAX does);
* a quiet group (jaxs <= QUIET): ours32 within
  min(QUIET_RATIO * jaxs, CAP). The cap fails a zeroed, halved or
  negated gradient (ours32 1, 0.5, 2) whatever jaxs is;
* a noisy group (jaxs > QUIET: the CNN encoders and ACPM's counters,
  whose bf16 gradients lie 0.14-0.63 from float32 in both packages at
  these sizes, through BatchNorm at random init; CCR-CLIP's image tower
  0.32 at batch 128 too): ours32 within
  NOISY_RATIO * jaxs, and the scale within SCALE_DROP below JAX's bf16
  scale and at most SCALE_MAX. bf16 shrinks these gradients along f by
  the same 4-18 % in both packages (the port's scale within 0.007 of
  JAX's), which no norm-relative distance can see under that noise: the
  scale bar fails a zeroed, halved or negated group;
* bf16 really runs: the encoder's gradients no nearer f than jaxs / 8
  (a float32 step sits at ~1e-5);
* NEAR_FP32: OI-CTR's reconstructor, whose bias gradients XLA:CPU sums
  in bf16 (JAX's scale 0.397, jaxs 0.76), is held to f alone, where the
  port sits at 1.9e-3.
`run_case` prints every group's readings (with -s); PERF.md section 2
records them."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.train.state import TrainState
from torch_ctr_cases import (CLIP, CLIP_VISION, OICTR as OI, SLD,
                             capture_grads_tx, init, leaves, no_port_dropout,
                             no_update)
from torch_ctr_step_cases import (B, L, _batches, _jax_step, clip_jax,
                                  clip_text, images, labels,
                                  no_dropout, oictr_fake)  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16


JAX_ROUNDING = {"xla_allow_excess_precision": False}
QUIET, QUIET_RATIO, CAP = 0.1, 2.0, 0.1
NOISY_RATIO, SCALE_DROP, SCALE_MAX = 1.25, 0.05, 1.1
NEAR_FP32 = {"['reconstructor']": 1e-2}
ENCODERS = ("['encoder']", "['visual']")


def _readings(got, bf, fp, keys):
    """(ours, ours32, jaxs, the port's scale, JAX's bf16 scale) over the
    leaves `keys` together, norm-relative to JAX's float32 step's."""
    g, b, f = (np.concatenate([np.asarray(t[k], np.float64).ravel()
                               for k in keys]) for t in (got, bf, fp))
    ff = max(float(f @ f), 1e-60)
    ref = ff ** 0.5
    return (np.linalg.norm(g - b) / ref, np.linalg.norm(g - f) / ref,
            np.linalg.norm(b - f) / ref, float(g @ f) / ff,
            float(b @ f) / ff)


def check_group(kind, group, readings):
    ours, ours32, jaxs, scale, jax_scale = readings
    what = (kind, group, readings)
    if kind == "grads" and group in NEAR_FP32:
        assert ours32 <= NEAR_FP32[group], what
        return
    assert ours <= QUIET_RATIO * jaxs, what
    if jaxs <= QUIET:
        assert ours32 <= min(QUIET_RATIO * jaxs, CAP), what
    else:
        assert ours32 <= NOISY_RATIO * jaxs, what
        assert jax_scale - SCALE_DROP <= scale <= SCALE_MAX, what
    if kind == "grads" and group in ENCODERS:
        assert ours32 >= jaxs / 8, what


def hold_bf16_step(model, porter, loss, jax_bf16, jax_fp32, porter_kw=None):
    """`jax_bf16` / `jax_fp32`: (TrainState after a `capture_grads_tx`
    step, loss). Returns the readings by group for the report."""
    from fudanocr_tpu_torch.utils.weights import (grad_state_dict,
                                                  to_jax_variables)

    (sbf, lbf), (s32, l32) = jax_bf16, jax_fp32
    loss_rel = abs(float(loss) - float(lbf)) / abs(float(lbf))
    assert np.isfinite(float(loss)) and loss_rel <= 1e-2, (loss, lbf)
    back = to_jax_variables(grad_state_dict(model), porter,
                            **(porter_kw or {}))
    out = {"loss_rel": loss_rel}
    for kind, got, bf, fp in (
            ("grads", leaves(back["params"]), leaves(sbf.opt_state),
             leaves(s32.opt_state)),
            ("stats", leaves(back["batch_stats"]), leaves(sbf.batch_stats),
             leaves(s32.batch_stats))):
        assert got.keys() == bf.keys() == fp.keys()
        groups = {}
        for k in sorted(fp):
            groups.setdefault(k.split("]")[0] + "]", []).append(k)
        for group, keys in groups.items():
            readings = _readings(got, bf, fp, keys)
            out[f"{kind} {group}"] = tuple(f"{r:.3g}" for r in readings)
            check_group(kind, group, readings)
    return out


def _jax_pair_steps(step, v, host, *args):
    """JAX's step in bf16 and in float32: `step(bf16)` builds each."""
    return [_jax_step(step(bf16), v, host, *args, x64=False,
                      compiler_options=JAX_ROUNDING)
            for bf16 in (True, False)]


def sld_case():
    from fudanocr_tpu.core.mesh import make_mesh_for_batch
    from fudanocr_tpu.models.rec import ocr_transformer as jocr
    from fudanocr_tpu.train import ctr as jctr
    from fudanocr_tpu_torch.apps.sld.train import (STROKE_ALPHABET,
                                                   synthetic_stroke_table)
    from fudanocr_tpu_torch.data.codecs import SequenceCodec
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.train.ctr import make_ctr_train_step
    from fudanocr_tpu_torch.utils.weights import load_jax_variables

    v = init(jocr.OCRTransformer(**SLD), np.zeros((B, 32, 32, 3),
                                                  np.float32),
             np.zeros((B, L), np.int32))
    m = no_port_dropout(load_jax_variables(
        OCRTransformer(**SLD, dtype=BF), "ocr_transformer", v,
        layers=SLD["layers"]))
    codec = SequenceCodec(STROKE_ALPHABET, synthetic_stroke_table(),
                          terminator="$")
    jb, tb = _batches(images(32, 32), codec, labels(2, 1), False)
    steps = _jax_pair_steps(lambda bf16: jctr.make_ctr_train_step(
        jocr.OCRTransformer(**SLD, dtype=jnp.bfloat16 if bf16 else None),
        make_mesh_for_batch(B), wrap_jit=False), v, jb,
        jax.random.PRNGKey(0))
    got = make_ctr_train_step(m, no_update(m))(tb)
    return m, "ocr_transformer", {"layers": SLD["layers"]}, got, steps


def oictr_case():
    from fudanocr_tpu.apps.oictr.train import OICTRTrainer as JaxTrainer
    from fudanocr_tpu.models.rec.oictr import OICTR as JaxOICTR
    from fudanocr_tpu_torch.apps.oictr import train as oictr_app
    from fudanocr_tpu_torch.data.codecs import SequenceCodec
    from fudanocr_tpu_torch.models.rec.oictr import OICTR
    from fudanocr_tpu_torch.utils.weights import load_jax_variables
    from torch_ctr_step_cases import CHARS

    v = init(JaxOICTR(**OI), np.zeros((B, 32, 64, 3), np.float32),
             np.zeros((B, L), np.int32))
    m = no_port_dropout(load_jax_variables(
        OICTR(image_size=(32, 64), **OI, dtype=BF), "oictr", v))
    codec = SequenceCodec(["<"] + list(CHARS) + ["$"], None, terminator="$")
    host = oictr_app.OICTRTrainer.host_batch(
        oictr_fake(codec), images(32, 64, 7), labels(8, L - 1),
        np.array([1, 0, 0, 1]))
    steps = _jax_pair_steps(lambda bf16: JaxTrainer._make_train_step(
        types.SimpleNamespace(model=JaxOICTR(
            **OI, dtype=jnp.bfloat16 if bf16 else None))).__wrapped__,
        v, host, jax.random.PRNGKey(0))
    got = oictr_app.make_oictr_train_step(m, no_update(m))(
        {k: torch.from_numpy(a) for k, a in host.items()})
    return m, "oictr", {}, got, steps


def clip_case(monkeypatch, b=3):
    """Stage 1 on a batch of 3 with a duplicate label, or at `b` = 128,
    the batch of the card's bf16 stage-1 step (chip_smoke.py phase 35),
    on random texts and labels."""
    from fudanocr_tpu.apps.ccr_clip.pretrain import CLIPPretrainer
    from fudanocr_tpu.models.rec import ccr_clip as jccr
    from fudanocr_tpu_torch.apps.ccr_clip.pretrain import make_clip_train_step
    from fudanocr_tpu_torch.losses.clip_loss import first_occurrence_targets
    from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP
    from fudanocr_tpu_torch.utils.weights import load_jax_variables
    from torch_ctr_cases import small_clip_vision

    _, v = clip_jax()
    small_clip_vision(monkeypatch)
    kw = {"layers": CLIP_VISION,
          "transformer_layers": CLIP["transformer_layers"]}
    m = load_jax_variables(CCRCLIP(vision_layers=CLIP_VISION, **CLIP,
                                   dtype=BF), "ccr_clip", v, **kw)
    if b == 3:
        x = images(32, 32, 8, b=2)
        x = np.concatenate([x, x[:1]])
        t = np.concatenate([clip_text(9), clip_text(9)[:1]])
        targets = first_occurrence_targets(["p", "q", "p"])
    else:
        x, t = images(32, 32, 8, b=b), clip_text(9, b=b)
        rng = np.random.default_rng(3)
        targets = first_occurrence_targets(
            [str(rng.integers(0, b)) for _ in range(b)])
    steps = []
    for bf16 in (True, False):
        jm = jccr.CCRCLIP(**CLIP, dtype=jnp.bfloat16 if bf16 else None)
        step = CLIPPretrainer._make_train_step(types.SimpleNamespace(
            model=jm))
        state = TrainState.create(v["params"], v["batch_stats"],
                                  capture_grads_tx())
        steps.append(jax.jit(step.__wrapped__,
                             compiler_options=JAX_ROUNDING)(
            state, jnp.asarray(x), jnp.asarray(t), jnp.asarray(targets)))
    got = make_clip_train_step(m, no_update(m))(
        torch.from_numpy(x), torch.from_numpy(t).long(),
        torch.from_numpy(targets))
    return m, "ccr_clip", kw, got, steps


def acpm_case():
    from fudanocr_tpu.apps.acpm.train import ACPMTrainer as JaxTrainer
    from fudanocr_tpu_torch.apps.acpm import train as app
    from test_torch_ctr_acpm import _host_batch, _jax_model, _pair

    _, v, _ = _jax_model()
    _, _, m = _pair(dtype=BF)
    m = no_port_dropout(m)
    host = _host_batch(20)
    cfg = types.SimpleNamespace(rn_loss="L1", pretrain=False)
    steps = _jax_pair_steps(lambda bf16: JaxTrainer._make_train_step(
        types.SimpleNamespace(model=_jax_model(bf16=bf16)[0],
                              cfg=cfg)).__wrapped__,
        v, host, jax.random.PRNGKey(0))
    got = app.make_acpm_train_step(m, no_update(m))(
        {k: torch.from_numpy(a) for k, a in host.items()})
    return m, "acpm", {}, got, steps


def run_case(which, monkeypatch):
    case = {"sld": sld_case, "oictr": oictr_case, "acpm": acpm_case,
            "clip": lambda: clip_case(monkeypatch),
            "clip128": lambda: clip_case(monkeypatch, 128)}[which]
    m, porter, kw, got, (jbf, j32) = case()
    res = hold_bf16_step(m, porter, got, jbf, j32, kw)
    print(f"{which} bf16 step: loss {float(got)} vs JAX bf16 "
          f"{float(jbf[1])}, fp32 {float(j32[1])}; (ours, ours vs fp32, "
          f"jaxs, scale, JAX's scale) by group: {res}")


@pytest.mark.parametrize("which", ["sld", "oictr"])
def test_bf16_step_matches_jax(no_dropout, monkeypatch, which):
    run_case(which, monkeypatch)
