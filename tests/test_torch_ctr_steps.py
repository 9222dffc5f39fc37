"""One train step of each CTR trainer of the port against the JAX
package's on the CPU, in float64 (tests/torch_ctr_step_cases.py): SLD,
CCR-CLIP stage 2 and OI-CTR; and OI-CTR's host batch builder against
JAX's. Bars (the training bar of PERF.md section 2): loss 1e-5 relative,
every gradient 1e-3 norm-relative per parameter, BatchNorm statistics
1e-5. In float64 the packages' encoders agree to rounding and no ReLU or
pool ties; tests/test_torch_ctr_steps_fp32.py holds the same steps in
float32."""

import numpy as np

from fudanocr_tpu_torch.apps.oictr import train as oictr_app
from fudanocr_tpu_torch.data.codecs import SequenceCodec
from torch_ctr_step_cases import (B, CHARS, L, images, labels,  # noqa: F401
                                  no_dropout, oictr_fake, oictr_step,
                                  sld_step, stage2_step)
from torch_threads import one_torch_thread  # noqa: F401


def test_sld_step_matches_jax(no_dropout):
    sld_step(x64=True)


def test_ccr_clip_stage2_step_matches_jax(no_dropout, monkeypatch):
    stage2_step(monkeypatch, x64=True)


def test_oictr_batch_builder_matches_jax():
    """The port's host batch is JAX's `_device_batch` given the same
    templates: ids, orientation, validity, rotated targets, swap."""
    from fudanocr_tpu.apps.oictr.train import OICTRTrainer as JaxTrainer

    codec = SequenceCodec(["<"] + list(CHARS) + ["$"], None, terminator="$")
    fake = oictr_fake(codec)
    args = (images(32, 64), labels(6, L), np.array([0, 1, 1, 0]))
    want = JaxTrainer._device_batch(fake, *args)
    got = oictr_app.OICTRTrainer.host_batch(fake, *args)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], np.asarray(w)), k
    assert got["char_valid"].sum() > 0
    assert not np.array_equal(got["swap_idx"], np.arange(B * L))


def test_oictr_step_matches_jax(no_dropout):
    oictr_step(x64=True)
