"""The det-guided seg recipe's train step against JAX (CE + Lovász + the
det loss x 0.1, the JAX step op by op; helpers and bars in
tests/test_torch_seg_train.py, whose docstring says what is held)."""

import pytest

from test_torch_seg_train import train_step_parity
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("det", [True])
def test_train_step_matches_jax(det):
    train_step_parity(det)
