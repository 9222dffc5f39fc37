"""Tensor-parallel placement (fudanocr_tpu_torch/parallel/tp.py), as
tests/test_parallel.py checks JAX's: the placement rules (torch weights
hold out-features on dim 0, flax kernels on their last axis), the
placement and its numerics over (data, model) = (2, 2) and (4, 1) meshes
on 4 gloo ranks, and the multi-rank dry run
(fudanocr_tpu_torch/parallel/dryrun.py) at N = 2 and 4, all started
together; at N = 4 its TBSRN step runs over placed parameters."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_ddp_cases as cases
from fudanocr_tpu_torch.parallel import last_dim_spec
from fudanocr_tpu_torch.parallel.dryrun import dryrun_multichip


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the tp case on 4 ranks, {N: the dry run's report})."""
    with ThreadPoolExecutor(3) as pool:
        tp = pool.submit(cases.run_ranks, 4, ["tp"],
                         tmp_path_factory.mktemp("tp"))
        dry = {n: pool.submit(dryrun_multichip, n) for n in (2, 4)}
        return ([r["tp"] for r in tp.result()],
                {n: f.result() for n, f in dry.items()})


def test_last_dim_spec_rules():
    w = torch.zeros(128, 64)        # torch Linear (out, in): flax's (64, 128)
    conv = torch.zeros(32, 16, 3, 3)
    b = torch.zeros(128)
    odd = torch.zeros(7, 4)
    assert last_dim_spec(w, 2) == (Replicate(), Shard(0))
    assert last_dim_spec(conv, 2) == (Replicate(), Shard(0))
    assert last_dim_spec(b, 2) == (Replicate(), Replicate())     # 1-D
    assert last_dim_spec(odd, 2) == (Replicate(), Replicate())   # indivisible
    assert last_dim_spec(w, 1) == (Replicate(), Replicate())     # no TP


def test_shard_params_tp_placement_and_numerics(runs):
    tp, _ = runs
    for rank, res in enumerate(tp):
        got = res[(2, 2)]
        assert got["placements"] == {
            "linear.weight": ["R", "S(0)"],
            "linear.bias": ["R", "R"],
            "odd.weight": ["R", "R"],
            "conv.weight": ["R", "S(0)"]}, rank
        # each rank holds half the out-features of the sharded weights
        assert got["local"]["linear.weight"] == (4, 4)
        assert got["local"]["conv.weight"] == (3, 3, 3, 3)
        assert got["local"]["linear.bias"] == (8,)
        assert got["equal"]
        # a product through the sharded weight is the plain product
        np.testing.assert_allclose(got["y"], got["want"], rtol=1e-14)


def test_shard_params_tp_degrades_to_replication(runs):
    tp, _ = runs
    for res in tp:
        got = res[(4, 1)]
        assert all(p == ["R", "R"]
                   for p in got["placements"].values())
        assert got["local"]["linear.weight"] == (8, 4) and got["equal"]
        np.testing.assert_allclose(got["y"], got["want"], rtol=1e-14)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(runs, n):
    """One TBSRN + text-focus-oracle step and one det-guided seg step on N
    ranks at JAX's tiny shapes, their losses finite and the same on every
    rank (the dry run raises otherwise), and equal at N = 2 and 4 (the
    same global batch of 8); at N = 4 the (2, 2) placement of TBSRN."""
    _, dry = runs
    lines = dry[n]
    assert lines[0].startswith(f"dryrun_multichip({n}) ok: loss=")
    assert lines[1].startswith(f"dryrun seg det-guided({n}) ok: loss=")
    assert [ln.split("loss=")[1] for ln in lines[:2]] == \
        [ln.split("loss=")[1] for ln in dry[2][:2]]
    if n == 4:
        assert lines[2].startswith("dryrun placement (data=2, model=2) ok:")


def test_dryrun_runs_the_tp_step(runs):
    """At N = 4 the dry run's TBSRN step is the tensor-parallel one, over
    (data 2, model 2) with parameters sharded, its loss the same on every
    rank and the data-parallel step's at N = 2."""
    _, dry = runs
    line = dry[4][3]
    assert line.startswith("dryrun tensor-parallel TBSRN step (data=2, "
                           "model=2) ok: ")
    sharded = int(line.split("ok: ")[1].split(" of ")[0])
    assert sharded >= 10
    assert line.split("loss=")[1].split()[0] == \
        dry[2][0].split("loss=")[1]
