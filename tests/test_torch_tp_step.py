"""TBSRN's text-focus step over placed parameters (fudanocr_tpu_torch/
parallel/tp.py `TensorParallel`, train/sr.make_sr_train_step on a
('data', 'model') DeviceMesh) on 4 gloo ranks, against one process on the
global batch, in float64 (tests/torch_ddp_cases.py `tp_step_case`: no STN,
1 SRB, dropout on, 2 steps at global batch 4, Adam at eps 1 as the
data-parallel cases set it):

* over (data 2, model 2): every step's metrics and the whole state after
  the steps (the sharded parameters gathered back, BatchNorm statistics
  included) within 1e-9 of each group's scale (`assert_same_run`), the
  clip's pre-clip float32 global norm within 1e-6 of one process's;
* before the steps each rank's placed parameters (`placed()`, DTensors
  of its local tensors) are `shard_params_tp`'s, placements and values;
  after them each rank's shard of each sharded parameter equals its rows
  of the one-process update (1e-9 of the state's scale), the replicated
  parameters the whole of it;
* over (data 4, model 1) the step is the data-parallel step
  (`make_mesh_for_batch`) on the same ranks bit for bit.

The dry run's tensor-parallel step is held in tests/test_torch_tp.py,
which runs `dryrun_multichip(4)` once for both.
"""

import numpy as np
import pytest
import torch

import torch_ddp_cases as cases
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's tp_step_case, every rank's results)."""
    wait = cases.start_ranks(4, ["tp_step", "tp_model1", "tp_data"],
                             tmp_path_factory.mktemp("tp_step"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = cases.CASES["tp_step"]()
    finally:
        torch.set_num_threads(n)
    return want, wait()


@pytest.mark.parametrize("rank", range(4))
def test_tp_step_equals_one_process(runs, rank):
    want, got = runs
    res = got[rank]["tp_step"]
    cases.assert_same_run(res, want, f"tp_step rank {rank} of 4")
    for g, w in zip(res["steps"], want["steps"]):
        assert g["grad_norm"] == pytest.approx(w["grad_norm"],
                                               rel=cases.F32_REL)
    assert want["moved"] > 1e-6
    assert res["moved"] == pytest.approx(want["moved"], rel=1e-6)


@pytest.mark.parametrize("rank", range(4))
def test_each_shard_is_its_rows_of_the_update(runs, rank):
    want, got = runs
    res = got[rank]["tp_step"]
    index = res["model_index"]
    assert index == rank % 2            # 'model' is the inner mesh axis
    assert res["placed_as_shard_params_tp"]
    assert len(res["sharded"]) >= 10
    top = max(float(np.abs(v).max()) for v in want["state"].values())
    for name, shard in res["shards"].items():
        full = want["state"][name]
        if name in res["sharded"]:
            n = full.shape[0] // 2
            assert shard.shape == (n,) + full.shape[1:], name
            full = full[index * n:(index + 1) * n]
        assert np.abs(shard - full).max() <= cases.REL * top, name


def test_model_axis_of_one_is_the_data_parallel_step(runs):
    _, got = runs
    for rank, res in enumerate(got):
        tp, dp = res["tp_model1"], res["tp_data"]
        assert tp["steps"] == dp["steps"], rank
        assert tp["state"].keys() == dp["state"].keys()
        for k, v in dp["state"].items():
            assert np.array_equal(tp["state"][k], v), (rank, k)
        assert tp["moved"] > 1e-6
