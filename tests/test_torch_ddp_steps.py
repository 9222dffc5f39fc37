"""Each trainer that the JAX package shards, data-parallel on gloo ranks
against one process on the global batch, in float64
(tests/torch_ddp_cases.py): `SRTrainer` (TBSRN with dropout on: the hash
dropout keyed on the global image index, the feed-forward dropout drawn
globally), `StrokeSRTrainer` (the stroke-focus loss), `SegTrainer` (the
plain recipe with drop-path and head dropout, and the det-guided one with
CE + Lovász + 0.1 det), SLD through `CTRTrainer`, and `GANSRTrainer`'s
two steps, each on 2 ranks, and the det-guided `SegTrainer` on 4. Each
run takes 2 steps and (but the GAN) evaluates: every step's metrics, every
parameter and buffer (BatchNorm statistics included) after them and the
evaluation's metrics equal one process's within 1e-9 of their group's
scale (`assert_same_run`; the clip's float32 global norm and the GAN's
float32 pixel L1 within 1e-6). The ranks run while this process computes
the single-process references. On the card (marked `cuda`): B4's and
B11's kernels at a batch offset against rows of one call on the global
batch (this file imports no JAX, so it runs there)."""

import pytest
import torch

import torch_ddp_cases as cases
from fudanocr_tpu_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

TWO = ("sr", "stroke", "seg", "seg_det", "sld", "gan")
FOUR = ("seg_det",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: one process's result}, {world: every rank's results})."""
    import torch

    two = cases.start_ranks(2, TWO, tmp_path_factory.mktemp("two"))
    four = cases.start_ranks(4, FOUR, tmp_path_factory.mktemp("four"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = {name: cases.CASES[name]() for name in TWO}
    finally:
        torch.set_num_threads(n)
    return want, {2: two(), 4: four()}


@pytest.mark.parametrize("world,case", [(2, c) for c in TWO]
                         + [(4, c) for c in FOUR])
def test_ranks_equal_one_process(runs, world, case):
    want, got = runs
    assert len(got[world]) == world
    for rank, res in enumerate(got[world]):
        cases.assert_same_run(res[case], want[case],
                              f"{case} rank {rank} of {world}")


@pytest.mark.parametrize("case", TWO)
def test_runs_train(runs, case):
    """The comparison is not between two untouched states: two steps with
    finite metrics, and the state moved from its seeded start (both nets
    of the GAN) by far more than the bar."""
    want, got = runs
    res = want[case]
    assert len(res["steps"]) == 2
    for step in res["steps"]:
        assert all(abs(v) < float("inf") for v in step.values()), step
    assert res["moved"] > 1e-6
    assert all(r[case]["moved"] == pytest.approx(res["moved"], rel=1e-6)
               for r in got[2])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernels_at_offset_are_global_rows(cuda, dtype):
    """B4's and B11's kernels at offset 32 (a second rank's first row of a
    global batch of 64): the device hash, and the forward and backward of
    both entries, equal rows [32, 64) of one call on the global batch."""
    b, heads, l, seed, rate = 32, 4, 1024, 4321, 0.1
    d = heads * 32
    assert torch.equal(
        fa.dropout_keep_mask_cuda(seed, b, heads, l, rate, cuda,
                                  offset=b).cpu(),
        fa.dropout_keep_oracle(2 * b, heads, l, seed, rate)[b:])
    g = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn((2 * b, l, 3 * d), generator=g, device=cuda,
                      dtype=dtype)
    dout = torch.randn((2 * b, l, d), generator=g, device=cuda, dtype=dtype)
    x = qkv.clone().requires_grad_()
    fa.flash_mha_qkv_packed_dropout(x, seed, heads, rate).backward(dout)
    xr = qkv[b:].clone().requires_grad_()
    o = fa.flash_mha_qkv_packed_dropout(xr, seed, heads, rate, offset=b)
    o.backward(dout[b:])
    want = fa.flash_mha_qkv_packed_dropout(qkv, seed, heads, rate)
    assert torch.equal(o, want[b:]) and torch.equal(xr.grad, x.grad[b:])
    q, k, v = (qkv[..., i * d:(i + 1) * d].contiguous() for i in range(3))
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_mha_packed_dropout(*full, seed, heads, rate).backward(dout)
    rows = [t[b:].clone().requires_grad_() for t in (q, k, v)]
    o11 = fa.flash_mha_packed_dropout(*rows, seed, heads, rate, offset=b)
    o11.backward(dout[b:])
    assert torch.equal(o11, fa.flash_mha_packed_dropout(
        q, k, v, seed, heads, rate)[b:])
    assert all(torch.equal(r.grad, f.grad[b:]) for r, f in zip(rows, full))
