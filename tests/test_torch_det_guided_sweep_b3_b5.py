"""Every `*_det` config of backbones b3-b5 runs through the port's
`init_segmentor` -> `inference_segmentor` at a narrow width on the CPU
(see tests/test_torch_det_guided_sweep.py)."""

import pytest

from test_torch_det_guided_sweep import run_det_configs
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("backbone", ["b3", "b4", "b5"])
def test_every_det_config_runs_at_a_narrow_width(backbone):
    run_det_configs(backbone)
