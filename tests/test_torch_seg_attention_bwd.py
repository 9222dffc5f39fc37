"""The gradients of the port's segmentation attention (fudanocr_tpu_torch/
ops/region_attention.py `packed_flash_mha` B7 and `region_flash_mha` B6,
ops/flash_attention.py `flash_mha` B5) against the JAX package on the CPU,
on the same seeded numpy inputs, fp32:

* the plain backwards (`packed_flash_mha_bwd_reference`,
  `region_flash_mha_bwd_reference`) and autograd through the plain
  forwards equal `jax.vjp` of the JAX `packed_flash_mha` / `region_flash_mha`
  (their Pallas backwards in interpret mode, as tests/test_region_attention.py
  runs them) at q (2, 1024, 64), k/v (2, 128, 64), 2 heads, with fully
  suppressed rows and 0.5 ids; ids get no gradient on either side;
* `flash_mha_bwd_reference` and autograd through `flash_mha`'s plain
  forward equal `jax.vjp` of the JAX `flash_mha` (plain XLA VJP);
* on CPU tensors the wrappers differentiate the plain versions and launch
  nothing.

Tolerance: atol 1e-5 on gradients of magnitude ~1 (the same math in
another summation order; measured ~1e-6).

Tests marked `cuda` hold the backward kernels of csrc/unmasked_attention.cu
against the plain backward on the card (the fp32 split-TF32 kernels also at
the edge cases of tests/torch_attention_cases.py) and skip where there is
none:

    python -m pytest tests/test_torch_seg_attention_bwd.py -m cuda --noconftest
"""

import re

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.ops import region_attention as ra
from torch_attention_cases import FP32_CASES, edge_qkv

ATOL = 1e-5
B, LQ, LKV, D, HEADS = 2, 1024, 128, 64, 2


def _inputs(seed, b=B, lq=LQ, lkv=LKV, d=D):
    """q, k, v, dO and ids: image 0 mixes ids {0, 0.5, 1} (and 3 on some q
    rows, which suppresses nothing); image 1 gives every key id 1, so its
    q rows with id 1 are fully suppressed and those with id 0.5 free."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, lq, d), (b, lkv, d), (b, lkv, d),
                             (b, lq, d)))
    rq = rng.choice(np.float32([0, 0.5, 1, 3]), (b, lq)).astype(np.float32)
    rkv = rng.choice(np.float32([0, 0.5, 1]), (b, lkv)).astype(np.float32)
    rkv[1] = 1.0
    rq[1] = np.where(rng.random(lq) < 0.5, 1.0, 0.5)
    return q, k, v, do, rq, rkv


def _jax_grads(masked, q, k, v, do, rq, rkv):
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import region_attention as jra

    jnp = jax.numpy
    assert jra.region_flash_supported(LQ, LKV, D, HEADS)   # the kernels
    if masked:
        fn = lambda q_, k_, v_, a, b: jra.region_flash_mha(q_, k_, v_, a, b,
                                                           HEADS)
        args = (q, k, v, rq, rkv)
    else:
        fn = lambda q_, k_, v_: jra.packed_flash_mha(q_, k_, v_, HEADS)
        args = (q, k, v)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("masked", [False, True])
def test_plain_backward_matches_jax_vjp(masked):
    q, k, v, do, rq, rkv = _inputs(0)
    want = _jax_grads(masked, q, k, v, do, rq, rkv)
    t = [torch.from_numpy(a) for a in (q, k, v, do, rq, rkv)]
    if masked:
        got = ra.region_flash_mha_bwd_reference(t[0], t[1], t[2], t[4], t[5],
                                                t[3], HEADS)
        # the JAX ids' cotangents are zeros
        np.testing.assert_array_equal(want[3], 0)
        np.testing.assert_array_equal(want[4], 0)
    else:
        got = ra.packed_flash_mha_bwd_reference(*t[:4], HEADS)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")
    assert np.abs(want[0]).max() > 0.1          # the gradients are not trivial


@pytest.mark.parametrize("masked", [False, True])
def test_autograd_through_plain_forward_matches_jax_vjp(masked):
    """On CPU tensors the wrappers run the plain forward and autograd
    differentiates it; the ids get no gradient."""
    q, k, v, do, rq, rkv = _inputs(1)
    want = _jax_grads(masked, q, k, v, do, rq, rkv)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    rqt = torch.from_numpy(rq).requires_grad_()
    counts = (ra.unmasked_packed_fwd.launches, ra.region_packed_fwd.launches,
              ra.unmasked_packed_bwd.launches, ra.region_packed_bwd.launches)
    o = (ra.region_flash_mha(qt, kt, vt, rqt, torch.from_numpy(rkv), HEADS)
         if masked else ra.packed_flash_mha(qt, kt, vt, HEADS))
    o.backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", (qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")
    assert rqt.grad is None
    assert counts == (ra.unmasked_packed_fwd.launches,
                      ra.region_packed_fwd.launches,
                      ra.unmasked_packed_bwd.launches,
                      ra.region_packed_bwd.launches)


def test_fully_suppressed_rows_have_the_uniform_gradient():
    """A row whose every key shares its id attends uniformly: its dq is
    the gradient of the mean of v, ds = (dp - mean(dp)) / Lkv."""
    q, k, v, do, rq, rkv = (torch.from_numpy(a) for a in _inputs(2))
    dq, _, _ = ra.region_flash_mha_bwd_reference(q, k, v, rq, rkv, do, HEADS)
    full = rq[1] == 1.0
    dh = D // HEADS
    for h in range(HEADS):
        cols = slice(h * dh, (h + 1) * dh)
        dp = do[1][full][:, cols] @ v[1][:, cols].T
        ds = (dp - dp.mean(-1, keepdim=True)) / LKV
        want = ds @ k[1][:, cols] / dh ** 0.5
        torch.testing.assert_close(dq[1][full][:, cols], want, rtol=0,
                                   atol=ATOL)


def test_flash_mha_backward_matches_jax_vjp():
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import flash_attention as jfa

    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((1, 2, 512, 32)).astype(np.float32)
                   for _ in range(4))
    _, vjp = jax.vjp(jfa.flash_mha, *map(jax.numpy.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jax.numpy.asarray(do))]
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    got = fa.flash_mha_bwd_reference(*t)
    qt, kt, vt = (a.clone().requires_grad_() for a in t[:3])
    n0 = fa.unmasked_bhld_fwd.launches
    fa.flash_mha(qt, kt, vt).backward(t[3])
    assert fa.unmasked_bhld_fwd.launches == n0
    for name, g, a, w in zip("qkv", got, (qt, kt, vt), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=f"autograd d{name}")


def test_backward_q_slices_cover_lq():
    """The dK/dV pass splits Lq into slices of a multiple of 64 rows that
    cover it, at least half of BWD_TARGET_BLOCKS blocks in all (rounding
    the slices to 64 rows costs up to half) where Lq allows."""
    for b, h, lq, lk in [(2, 1, 65536, 1024), (2, 2, 16384, 1024),
                         (2, 5, 4096, 1024), (2, 8, 1024, 1024),
                         (8, 1, 16384, 256), (8, 2, 4096, 256),
                         (8, 5, 1024, 256), (1, 1, 128, 128)]:
        chunk = ra.bwd_q_chunk(b, h, lq, lk)
        splits = -(-lq // chunk)
        assert chunk % 64 == 0 and 64 <= chunk <= lq
        assert (splits - 1) * chunk < lq <= splits * chunk
        blocks = splits * b * h * (lk // 128)
        assert blocks >= min(ra.BWD_TARGET_BLOCKS // 2,
                              b * h * (lq // 64) * (lk // 128))


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,lq,lkv,d,heads", [(2, 4096, 1024, 32, 1),
                                              (2, 2048, 512, 128, 2),
                                              (1, 1024, 256, 256, 8)])
def test_backward_kernel_matches_plain_backward(cuda, dtype, masked, b, lq,
                                                lkv, d, heads):
    q, k, v, do, rq, rkv = (torch.from_numpy(a).to(cuda) for a in
                            _inputs(lq + d, max(b, 2), lq, lkv, d))
    q, do = q[:b].to(dtype), do[:b].to(dtype)
    kv = torch.cat([k, v], -1)[:b].to(dtype)
    k, v = kv[..., :d], kv[..., d:]          # row stride 2D, read in place
    rq, rkv = rq[:b].contiguous(), rkv[:b].contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = (ra.unmasked_packed_bwd.launches, ra.region_packed_bwd.launches)
    o = (ra.region_flash_mha(*leaves, rq, rkv, heads) if masked
         else ra.packed_flash_mha(*leaves, heads))
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    n1 = (ra.unmasked_packed_bwd.launches, ra.region_packed_bwd.launches)
    assert n1 == ((n0[0], n0[1] + 1) if masked else (n0[0] + 1, n0[1]))
    want = (ra.region_flash_mha_bwd_reference(q, k, v, rq, rkv, do, heads)
            if masked else ra.packed_flash_mha_bwd_reference(q, k, v, do,
                                                             heads))
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _rel(g, w) <= REL[dtype]


@pytest.mark.cuda
def test_flash_mha_gradient_on_the_card(cuda):
    q, k, v = (torch.randn(1, 2, 512, 32, device=cuda, requires_grad=True)
               for _ in range(3))
    do = torch.randn(1, 2, 512, 32, device=cuda)
    got = torch.autograd.grad(fa.flash_mha(q, k, v), (q, k, v), do)
    want = fa.flash_mha_bwd_reference(q.detach(), k.detach(), v.detach(), do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


# the fp32 split-TF32 backward at its edge cases: (B, Lq, Lkv, D, heads,
# case); the ids of `_inputs` (fully suppressed rows in image 1)
FP32_BWD_EDGE = [(2, 1024, 128, 32, 1, "plain"),   # one key block
                 *((2, 1024, 256, 64, 2, c) for c in FP32_CASES
                   if c != "plain"),
                 (2, 1024, 256, 128, 2, "peaked"),   # dh 64
                 (2, 1024, 256, 128, 2, "large")]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,lq,lkv,d,heads,case", FP32_BWD_EDGE)
def test_fp32_backward_kernel_edge_cases(cuda, masked, b, lq, lkv, d, heads,
                                         case):
    q, k, v = edge_qkv(case, b, lq, lkv, d, cuda, seed=lq + d,
                       dtype=torch.float32)
    _, _, _, do, rq, rkv = (torch.from_numpy(a).to(cuda) for a in
                            _inputs(lq + d, b, lq, lkv, d))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = (ra.region_flash_mha(*leaves, rq, rkv, heads) if masked
         else ra.packed_flash_mha(*leaves, heads))
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    want = (ra.region_flash_mha_bwd_reference(q, k, v, rq, rkv, do, heads)
            if masked else ra.packed_flash_mha_bwd_reference(q, k, v, do,
                                                             heads))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= REL[torch.float32]
    if masked:   # the fully suppressed rows' dq on its own
        full = (rq[:, :, None] == rkv[:, None, :]).all(-1)
        assert full.any() and _rel(got[0][full], want[0][full]) <= \
            REL[torch.float32]


@pytest.mark.cuda
def test_fp32_backward_runs_the_tf32x3_kernels(cuda):
    """The fp32 backward's launches by name in a torch.profiler trace: the
    split-TF32 dQ and dK/dV passes and the reduce; bf16 the bf16
    tensor-core ones."""
    from torch.profiler import ProfilerActivity, profile

    for dtype, want in ((torch.float32, ["attn_bwd_dkv_tf32x3_kernel",
                                         "attn_bwd_dq_tf32x3_kernel",
                                         "attn_bwd_reduce_kernel"]),
                        (torch.bfloat16, ["attn_bwd_dkv_mma_kernel",
                                          "attn_bwd_dq_mma_kernel",
                                          "attn_bwd_reduce_kernel"])):
        q, k, v, do = (torch.from_numpy(a).to(cuda, dtype) for a in
                       _inputs(0, 2, 1024, 128, 64)[:4])
        leaves = [t.requires_grad_() for t in (q, k, v)]
        o = ra.packed_flash_mha(*leaves, 2)
        torch.autograd.grad(o, leaves, do, retain_graph=True)
        torch.cuda.synchronize()
        for _ in range(3):   # a trace now and then holds no device event
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.autograd.grad(o, leaves, do, retain_graph=True)
                torch.cuda.synchronize()
            names = sorted({re.split(r"[<(]", re.sub(
                r"^void |\(anonymous namespace\)::", "", e.key))[0]
                for e in prof.key_averages()
                if e.device_time_total > 0 and "attn_bwd" in e.key})
            if names:
                break
        assert names == want, (dtype, names)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d,heads", [(32, 1), (128, 2)])
def test_fp32_backward_with_do_off_16_bytes(cuda, masked, d, heads):
    """A contiguous dO whose base is one float past a 16-byte boundary: the
    dK/dV pass stages it with 4-byte copies."""
    q, k, v, do, rq, rkv = (torch.from_numpy(a).to(cuda) for a in
                            _inputs(d, 2, 1024, 256, d))
    buf = torch.empty(do.numel() + 1, device=cuda)
    do_off = buf[1:].view(do.shape)
    do_off.copy_(do)
    assert do_off.is_contiguous() and do_off.data_ptr() % 16 == 4
    if masked:
        _, o32, m, inv = ra.region_packed_fwd(q, k, v, rq, rkv, heads,
                                              stats=True)
        got = ra.region_packed_bwd(q, k, v, rq, rkv, o32, do_off, m, inv,
                                   heads)
        want = ra.region_flash_mha_bwd_reference(q, k, v, rq, rkv, do,
                                                 heads)
    else:
        _, o32, m, inv = ra.unmasked_packed_fwd(q, k, v, heads, stats=True)
        got = ra.unmasked_packed_bwd(q, k, v, o32, do_off, m, inv, heads)
        want = ra.packed_flash_mha_bwd_reference(q, k, v, do, heads)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= REL[torch.float32]
