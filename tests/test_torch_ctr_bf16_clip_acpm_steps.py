"""CCR-CLIP stage 1's and ACPM's training steps in bf16 against the JAX
package's bf16 steps on the CPU, under the bars of
tests/test_torch_ctr_bf16_steps.py (its cases and checks)."""

import pytest

from test_torch_ctr_bf16_steps import run_case
from torch_ctr_step_cases import no_dropout  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("which", ["clip", "acpm"])
def test_bf16_step_matches_jax(no_dropout, monkeypatch, which):
    run_case(which, monkeypatch)
