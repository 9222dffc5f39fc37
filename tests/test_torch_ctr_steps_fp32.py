"""The CTR trainers' train steps of tests/test_torch_ctr_steps.py and
tests/test_torch_ctr_clip.py in float32, the precision the card trains
in, against JAX's float32 steps (tests/torch_ctr_step_cases.py), at the
same bars: loss 1e-5 relative, gradients 1e-3 norm-relative per
parameter, BatchNorm statistics 1e-5.

In float32 the packages' convs round differently (~1e-6 relative after a
few layers), and a ReLU or max pool whose inputs lie that close opens or
picks on one side only. Measured on this host: on the SLD step one ReLU
input of 65536 in stage 2's first block, which moved every gradient
upstream of it by 4e-3 to 6e-3 while JAX's float32 step stayed within
1e-5 of float64; on CCR-CLIP stage 2's step, under this suite's XLA flags,
JAX's float32 encoder gradients land 2e-2 to 5e-2 from its own float64
ones while the port's stay within 3e-5 of its float64 ones. So those two
steps hold the loss and the gradients of every leaf outside the encoder
(worst 9.7e-6 and 4.1e-5); OI-CTR's and CCR-CLIP stage 1's hold every
gradient (worst 7.8e-6 and 2.9e-5)."""

from torch_ctr_step_cases import (clip_jax, clip_pretrain_step,  # noqa: F401
                                  no_dropout, oictr_step, outside_encoder,
                                  sld_step, stage2_step)
from torch_threads import one_torch_thread  # noqa: F401


def test_sld_fp32_step_matches_jax(no_dropout):
    sld_step(x64=False, hold=outside_encoder)


def test_ccr_clip_stage2_fp32_step_matches_jax(no_dropout, monkeypatch):
    stage2_step(monkeypatch, x64=False, hold=outside_encoder)


def test_oictr_fp32_step_matches_jax(no_dropout):
    oictr_step(x64=False)


def test_clip_pretrain_fp32_step_matches_jax(monkeypatch):
    clip_pretrain_step(monkeypatch, *clip_jax(), x64=False)
