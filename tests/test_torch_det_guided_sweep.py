"""Every `*_det` config runs through the port's `init_segmentor` ->
`inference_segmentor` at a narrow width on the CPU: backbones b0-b2 here,
b3-b5 in tests/test_torch_det_guided_sweep_b3_b5.py (two files, so that
the sweep spreads over two workers)."""

import glob

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.apps.seg import inference as pinf
from fudanocr_tpu_torch.models.seg import DetGuidedEncoderDecoder
from torch_threads import one_torch_thread  # noqa: F401


def run_det_configs(backbone: str) -> None:
    """`init_segmentor` -> `inference_segmentor` on the five `*_det`
    configs of one backbone size (of 30 in all), at embed_dims 8 and their
    own depths, on a 64x64 image."""
    paths = sorted(glob.glob("configs/seg/*_det.yaml"))
    assert len(paths) == 30
    paths = [p for p in paths if f"textformer_{backbone}_" in p]
    assert len(paths) == 5
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    for path in paths:
        m, cfg = pinf.init_segmentor(path, device="cpu", overrides=(
            "model.backbone.embed_dims=8", "model.decode_head.channels=32"))
        assert isinstance(m, DetGuidedEncoderDecoder), path
        assert (cfg.test.mode, cfg.test.crop) == ("slide", [1024, 1024])
        seg, logits = pinf.inference_segmentor(m, img, return_logits=True)
        assert seg.shape == (64, 64) and torch.isfinite(logits).all(), path


@pytest.mark.parametrize("backbone", ["b0", "b1", "b2"])
def test_every_det_config_runs_at_a_narrow_width(backbone):
    run_det_configs(backbone)
