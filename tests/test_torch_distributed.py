"""The port's data parallelism (core/mesh.py) on the CPU: its helpers
without a process group, JAX's gcd rule, the striping, the collectives'
values and gradients, the global draws, BatchNorm and the losses over the
global batch on 3 gloo ranks (tests/torch_ddp_cases.py `mesh_case`, one
group for the whole file), the hash-dropout twins at a batch offset
against the rows of the global mask (and JAX's), and one witness against
JAX: the port's 2-rank TBSRN text-focus step against JAX's
`make_sr_train_step` jitted over `make_mesh_for_batch` on the conftest's
8 virtual CPU devices, under the bars of tests/test_torch_sr_train.py."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ddp_cases as cases
from fudanocr_tpu.core.mesh import make_mesh_for_batch as jax_mesh_for_batch
from fudanocr_tpu.losses.sr_losses import TextFocusLoss as JaxTextFocusLoss
from fudanocr_tpu.ops import flash_attention as jfa
from fudanocr_tpu.train.sr import make_sr_train_step as jax_train_step
from fudanocr_tpu.train.state import TrainState
from fudanocr_tpu_torch.core import mesh as M
from fudanocr_tpu_torch.data.workers import rows_of
from fudanocr_tpu_torch.losses import seg_losses
from fudanocr_tpu_torch.losses.sr_losses import encode_text_labels
from fudanocr_tpu_torch.nn.layers import batch_norm, dropout
from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.train.ctr import masked_token_ce
from test_torch_sr_train import (ORACLE, _leaves, no_dropout,  # noqa: F401
                                 step_setup)
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 3
F64 = torch.float64
HEADS, RATE, SEED = 4, 0.1, 4321


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's `mesh_case` results from one 3-rank gloo group."""
    return [r["mesh"] for r in cases.run_ranks(
        WORLD, ["mesh"], tmp_path_factory.mktemp("mesh"))]


# -- without a process group --------------------------------------------------

def test_helpers_without_a_group_are_the_identity():
    assert M.world() == (0, 1)
    mesh = M.make_mesh_for_batch(8)
    assert (mesh.size, mesh.index, mesh.group) == (1, 0, None)
    assert mesh.writer and mesh.active and mesh.rows(8) == slice(0, 8)
    assert M.host_shard_indices(10, 4) == range(0, 10, 4)
    assert M.local_batch_size(8) == 8
    assert M.from_rank0("x") == "x"
    x = torch.arange(6.0)
    with M.data_parallel(mesh):      # one rank: nothing is active
        assert M.current() is None
        assert M.all_reduce_sum(x) is x and M.all_gather(x) is x
        assert M.batch_offset(7) == 0
        assert torch.equal(M.mean_share(x), x.mean())
        assert torch.equal(M.batch_mean(x), x.mean())
        assert torch.equal(
            M.global_rand((2, 3), torch.Generator().manual_seed(1), "cpu"),
            torch.rand((2, 3), generator=torch.Generator().manual_seed(1)))
    assert M.reduce_sums([1.5, 2], mesh) == [1.5, 2.0]


def test_rows_and_shards():
    assert rows_of(list(range(8)), (0, 1)) == list(range(8))
    assert rows_of(range(8), (1, 2)) == range(4, 8)
    with pytest.raises(ValueError):
        rows_of(range(6), (0, 4))
    m = M.Mesh(2, 1, None)
    assert m.rows(6) == slice(3, 6) and m.shard == (1, 2)
    hr, labels = np.arange(12).reshape(6, 2), list("abcdef")
    got = M.shard_batch(m, {"hr": hr, "pair": (hr, labels), "n": 3})
    np.testing.assert_array_equal(got["hr"], hr[3:])
    np.testing.assert_array_equal(got["pair"][0], hr[3:])
    assert got["pair"][1] == ["d", "e", "f"] and got["n"] == 3


def test_setup_distributed_reads_torchrun_environment(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert M.setup_distributed("cpu") == 0      # no torchrun: nothing
    assert not torch.distributed.is_initialized()
    assert M.local_device("cuda") == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert M.local_device("cuda") == torch.device("cuda", 3)
    assert M.local_device("cuda:1") == torch.device("cuda", 1)
    assert M.local_device("cpu") == torch.device("cpu")


def test_gcd_rule_warns_with_jax_text(monkeypatch, caplog):
    monkeypatch.setattr(M, "world", lambda: (0, 3))
    with caplog.at_level(logging.WARNING, "fudanocr_tpu.mesh"):
        mesh = M.make_mesh_for_batch(4)
    assert (mesh.size, mesh.index) == (1, 0)
    assert ("batch 4 does not divide across 3 devices: using 1, leaving 2 "
            "idle — pad the batch to a multiple of 3 to use all devices"
            in caplog.text)


# -- on 3 gloo ranks ----------------------------------------------------------

def test_gcd_rule_and_striping_on_ranks(ranks):
    assert [r["m4"] for r in ranks] == [(1, 0), (1, None), (1, None)]
    assert [r["m6"] for r in ranks] == [(3, 0), (3, 1), (3, 2)]
    for k, r in enumerate(ranks):
        # JAX's striping: rank k reads rows [4k, 4k + 4) of each global
        # batch of 12
        assert r["stripes"] == list(range(4 * k, 30, 12))
        assert r["local_batch"] == 2
        assert r["offset"] == 0 and r["offset_in"] == 5 * k
        assert r["rows"] == (2 * k, 2 * k + 2)


def test_collectives_values_and_gradients(ranks):
    w = cases.mesh_inputs(WORLD)["w"]
    gathered = np.concatenate([np.arange(4.0) + 10 * k
                               for k in range(WORLD)])
    for k, r in enumerate(ranks):
        # s = sum_k (k + 1) x, and rank k's loss is (k + 1) s: rank k's x
        # enters every loss with weight k + 1, so its gradient is
        # (k + 1) x the sum of the losses' weights
        np.testing.assert_array_equal(r["sum"], np.arange(4.0) * 6)
        np.testing.assert_array_equal(r["sum_grad"],
                                      np.full(4, 6.0 * (k + 1)))
        np.testing.assert_array_equal(r["gather"], gathered)
        np.testing.assert_allclose(r["gather_grad"],
                                   w.sum(0)[4 * k:4 * k + 4], rtol=1e-15)


def test_global_draws_are_the_global_batch_rows(ranks):
    rand = torch.rand((6, 3), generator=torch.Generator().manual_seed(9))
    drop = dropout(torch.ones(6, 6, dtype=F64), 0.5,
                   torch.Generator().manual_seed(9))
    for k, r in enumerate(ranks):
        np.testing.assert_array_equal(r["rand"], rand[2 * k:2 * k + 2])
        np.testing.assert_array_equal(r["dropout"], drop[2 * k:2 * k + 2])


def test_batch_norm_is_the_global_batch(ranks):
    """Output, input and affine gradients and the flax running update
    (biased variance, C7) of one process on the global batch; each rank's
    loss weights its rows by (rank + 1)."""
    x = torch.from_numpy(cases.mesh_inputs(WORLD)["bn"]).requires_grad_()
    bn = torch.nn.BatchNorm2d(3).double()
    y = batch_norm(bn, x, train=True)
    scale = torch.arange(1, WORLD + 1, dtype=F64).repeat_interleave(2)
    (y * y * scale[:, None, None, None]).sum().backward()
    dw = sum(r["bn"]["dw"] for r in ranks)
    db = sum(r["bn"]["db"] for r in ranks)
    np.testing.assert_allclose(dw, bn.weight.grad.numpy(), rtol=1e-12)
    np.testing.assert_allclose(db, bn.bias.grad.numpy(), rtol=1e-12,
                               atol=1e-12)
    for k, r in enumerate(ranks):
        rows = slice(2 * k, 2 * k + 2)
        np.testing.assert_allclose(r["bn"]["y"], y.detach()[rows].numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r["bn"]["dx"], x.grad[rows].numpy(),
                                   rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(r["bn"]["mean"], bn.running_mean.numpy(),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(r["bn"]["var"], bn.running_var.numpy(),
                                   rtol=1e-12)


def test_losses_are_the_global_batch(ranks, monkeypatch):
    """The CE over valid pixels, Lovász (errors that tie: the ranks' stable
    global sort against one process sorting stably), the bucketed Lovász
    (all-reduced histograms), Dice, focal and Tversky, seg accuracy and the
    masked token CE: the ranks' shares sum to one process's loss, and each
    rank's gradient is that loss's gradient on its rows."""
    inp = cases.mesh_inputs(WORLD)
    monkeypatch.setattr(seg_losses, "_weights_in_place", functools.partial(
        seg_losses._weights_in_place, stable=True))
    labels = torch.from_numpy(inp["labels"])
    for name, fn_name in cases.SEG_LOSSES_BY_NAME.items():
        fn = getattr(seg_losses, fn_name)
        lg = torch.from_numpy(inp["seg"]).requires_grad_()
        loss = fn(lg, labels)
        loss.backward()
        for k, r in enumerate(ranks):
            np.testing.assert_allclose(r[name]["loss"], loss.item(),
                                       rtol=1e-14, err_msg=name)
            np.testing.assert_allclose(r[name]["grad"],
                                       lg.grad[2 * k:2 * k + 2].numpy(),
                                       rtol=1e-13, atol=1e-16, err_msg=name)
    acc = float(seg_losses.seg_accuracy(torch.from_numpy(inp["seg"]),
                                        labels))
    lg = torch.from_numpy(inp["tokens"]).requires_grad_()
    loss = masked_token_ce(lg, torch.from_numpy(inp["targets"]),
                           torch.from_numpy(inp["lengths"]))
    loss.backward()
    for k, r in enumerate(ranks):
        assert r["acc"] == pytest.approx(acc, rel=1e-7)   # float32 counts
        np.testing.assert_allclose(r["token_ce"]["loss"], loss.item(),
                                   rtol=1e-14)
        np.testing.assert_allclose(r["token_ce"]["grad"],
                                   lg.grad[2 * k:2 * k + 2].numpy(),
                                   rtol=1e-13, atol=1e-16)


# -- the hash-dropout twins at a batch offset ---------------------------------

@pytest.mark.parametrize("b,ranks_", [(4, 2), (3, 4)])
def test_dropout_masks_at_offset_are_global_rows(b, ranks_):
    """B4's and B11's plain twins at offset r·b: the keep mask is rows
    [r·b, (r + 1)·b) of the global batch's (the port's and JAX's oracle),
    and so are the outputs and gradients; offset 0 is today's call bit for
    bit."""
    l, d = 256, HEADS * 32
    full = fa.dropout_keep_oracle(b * ranks_, HEADS, l, SEED, RATE)
    want = np.asarray(jfa.dropout_keep_oracle(b * ranks_, HEADS, l,
                                              jnp.uint32(SEED), RATE))
    np.testing.assert_array_equal(full.numpy(), want)
    rng = np.random.default_rng(b)
    qkv = torch.from_numpy(rng.standard_normal((b * ranks_, l, 3 * d)))
    dout = torch.from_numpy(rng.standard_normal((b * ranks_, l, d)))
    x = qkv.clone().requires_grad_()
    out = fa.flash_mha_qkv_packed_dropout(x, SEED, HEADS, RATE)
    (out * dout).sum().backward()
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    out11 = fa.flash_mha_packed_dropout(*ys, SEED, HEADS, RATE)
    (out11 * dout).sum().backward()
    assert torch.equal(fa.dropout_keep_oracle(b, HEADS, l, SEED, RATE,
                                              offset=0),
                       fa.dropout_keep_oracle(b, HEADS, l, SEED, RATE))
    for r in range(ranks_):
        rows = slice(r * b, (r + 1) * b)
        assert torch.equal(fa.dropout_keep_oracle(b, HEADS, l, SEED, RATE,
                                                  offset=r * b), full[rows])
        xr = qkv[rows].clone().requires_grad_()
        o = fa.flash_mha_qkv_packed_dropout(xr, SEED, HEADS, RATE,
                                            offset=r * b)
        (o * dout[rows]).sum().backward()
        torch.testing.assert_close(o, out.detach()[rows], rtol=0, atol=0)
        torch.testing.assert_close(xr.grad, x.grad[rows], rtol=0, atol=0)
        yr = [t[rows].clone().requires_grad_() for t in (q, k, v)]
        o11 = fa.flash_mha_packed_dropout(*yr, SEED, HEADS, RATE,
                                          offset=r * b)
        (o11 * dout[rows]).sum().backward()
        torch.testing.assert_close(o11, out11.detach()[rows], rtol=0, atol=0)
        for a, full_grad in zip(yr, ys):
            torch.testing.assert_close(a.grad, full_grad.grad[rows], rtol=0,
                                       atol=0)
    with pytest.raises(ValueError):
        fa.dropout_keep_oracle(b, HEADS, l, SEED, RATE, offset=-1)


# -- the witness against JAX's sharded step -----------------------------------

def test_two_rank_sr_step_matches_jax_mesh(step_setup, no_dropout,
                                           tmp_path):
    """JAX's step jitted over `make_mesh_for_batch(2)` (2 of the 8 virtual
    devices, the batch sharded over 'data') and the port's step on 2 gloo
    ranks of one row each, from the same weights and batch, dropout off
    and Adam at lr = eps = 1 on both sides (test_train_step_matches_jax's
    setup and bars): the x100 loss and its terms, the BatchNorm statistics
    and every parameter after the step, on every rank."""
    jm, v, om, ov, (hr, lr, labels) = step_setup
    ti, tg, ln = encode_text_labels(labels, 32)
    batch = {"hr": hr, "lr": lr, "text_input": ti, "text_gt": tg,
             "lengths": ln}
    torch.save({"v": v, "ov": ov, "oracle_cfg": ORACLE, "batch": batch},
               tmp_path / "witness_in.pt")
    port = cases.start_ranks(2, ["witness"], tmp_path)
    tx = optax.chain(optax.clip_by_global_norm(0.25),
                     optax.adam(1.0, b1=0.5, b2=0.999, eps=1.0))
    state = TrainState.create(v["params"], v["batch_stats"], tx)
    mesh = jax_mesh_for_batch(2)
    assert mesh.shape["data"] == 2
    step = jax_train_step(jm, JaxTextFocusLoss(om, ov), mesh)
    new_state, want = step(state, {k: jnp.asarray(a)
                                   for k, a in batch.items()},
                           jax.random.PRNGKey(0))
    want_stats = _leaves(new_state.batch_stats)
    want_p, start = _leaves(new_state.params), _leaves(v["params"])
    for got in (r["witness"] for r in port()):
        assert got["mesh"][0] == 2
        m = got["metrics"]
        np.testing.assert_allclose(m["loss"], float(want["loss"]),
                                   rtol=1e-5)
        for k in ("mse", "attention", "recognition"):
            np.testing.assert_allclose(m[k], float(want[k]), rtol=1e-4,
                                       atol=1e-8, err_msg=k)
        assert m["grad_norm"] > 0.25      # the clip bit
        stats = _leaves(got["variables"]["batch_stats"])
        assert stats.keys() == want_stats.keys()
        for k, w in want_stats.items():
            np.testing.assert_allclose(stats[k], w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        got_p = _leaves(got["variables"]["params"])
        assert got_p.keys() == want_p.keys()
        for k, want_k in want_p.items():
            moved = np.abs(want_k - start[k]).max()
            tol = 2e-6 + (0.02 * moved if k.startswith("['stn_head']")
                          else 0)
            np.testing.assert_allclose(got_p[k], want_k, rtol=0, atol=tol,
                                       err_msg=k)
