"""An autouse fixture for the port's CPU test files: one torch intra-op
thread per test. Their tensors are small, and under the suite's parallel
workers (`-p xdist -n 6` on a host of 8 cores) every worker's torch thread
pool spins for the whole machine: a test that takes seconds alone then
takes minutes. A file activates it with

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
