"""The port's attention over separate packed q, k, v buffers
(fudanocr_tpu_torch/ops/flash_attention.py): `flash_mha_packed` (B10) and
`flash_mha_packed_dropout` (B11), against the JAX package on the CPU, on
the same seeded numpy inputs:

* the B10 twin equals the JAX Pallas `flash_mha_packed` run in interpret
  mode (B 2, 4 heads, dh 32, L 256): fp32 at 1e-5, bf16 at 2e-2 (both
  sides round the probabilities to bf16 for the value product and the
  output to bf16);
* the B11 twin equals the JAX `flash_mha_packed_dropout` (forward and its
  Pallas backward, interpret mode) at rate 0.1: fp32 at 1e-5;
* the split-operand twins equal the fused-qkv twins (B3, B4) exactly on
  the concatenated buffer, B11's gradients included (mirrors
  tests/test_flash_attention.py:114-150);
* the port's gate `flash_packed_supported` equals JAX's.

Tests marked `cuda` hold both kernels against their plain versions on the
card (B10's bf16 tensor-core forward and B11's bf16 tensor-core kernels
also at their edge cases, tests/torch_attention_cases.py), and B4 (the
same kernels on the fused buffer) against B11 bit for bit; they skip
where there is no card and import no jax:

    python -m pytest tests/test_torch_packed_attention.py -m cuda --noconftest
"""

import itertools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.ops import region_attention as ra
from torch_attention_cases import CASES, dropout_rounding_model, edge_qkv
from torch_threads import one_torch_thread  # noqa: F401

HEADS, D, RATE = 4, 128, 0.1
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MODEL_REL = 2e-3   # as tests/test_torch_flash_attention.py, and why


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import flash_attention as jfa
    return jax, jax.numpy, jfa


def _qkv(seed, b=2, l=256):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_twin_matches_jax_kernel(jx, dtype):
    _, jnp, jfa = jx
    ts = [torch.from_numpy(a).to(dtype) for a in _qkv(1)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jfa.flash_mha_packed(
        *(jnp.asarray(t.float().numpy(), jdt) for t in ts), HEADS)
        .astype(jnp.float32))
    got = fa.flash_mha_packed(*ts, HEADS)
    assert got.dtype == dtype and got.shape == (2, 256, D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype])


def test_packed_dropout_twin_matches_jax_kernels(jx):
    jax, jnp, jfa = jx
    arrays = _qkv(2)
    do = np.random.default_rng(3).standard_normal((2, 256, D)).astype(
        np.float32)
    seed = 1234

    def loss(q, k, v):
        o = jfa.flash_mha_packed_dropout(q, k, v, jnp.uint32(seed), HEADS,
                                         RATE)
        return (o * do).sum(), o

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = fa.flash_mha_packed_dropout(*ts, seed, HEADS, RATE)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])


def test_split_twins_equal_fused_twins():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4))
    qkv = torch.cat([q, k, v], -1)
    assert torch.equal(fa.flash_mha_qkv_packed(qkv, HEADS),
                       fa.flash_mha_packed(q, k, v, HEADS))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    xf = qkv.clone().requires_grad_()
    split = fa.flash_mha_packed_dropout(*xs, 77, HEADS, RATE)
    fused = fa.flash_mha_qkv_packed_dropout(xf, 77, HEADS, RATE)
    assert torch.equal(split, fused)
    do = torch.randn(split.shape, generator=torch.Generator().manual_seed(5))
    split.backward(do)
    fused.backward(do)
    assert torch.equal(xf.grad, torch.cat([t.grad for t in xs], -1))


def test_gate_matches_jax(jx):
    _, _, jfa = jx
    for lq, lk, d, heads in itertools.product(
            (256, 512, 768, 1000, 2048, 2304), (512, 768, 2048),
            (64, 96, 128, 384, 512, 640), (1, 2, 4, 5)):
        assert fa.flash_packed_supported(lq, lk, d, heads) == \
            jfa.flash_packed_supported(lq, lk, d, heads), (lq, lk, d, heads)


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_qkv(device, dtype, b, l, lk=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, D, generator=gen).to(device, dtype)
            for n in (l, lk or l, lk or l)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,lk", [(2, 512, 512), (1, 1024, 256),
                                    (3, 2048, 2048)])
def test_packed_kernel_matches_twin(cuda, dtype, b, l, lk):
    q, k, v = _card_qkv(cuda, dtype, b, l, lk, seed=l)
    n0, n7 = fa.flash_mha_packed.launches, ra.unmasked_packed_fwd.launches
    got = fa.flash_mha_packed(q, k, v, HEADS)
    torch.cuda.synchronize()
    assert fa.flash_mha_packed.launches == n0 + 1
    assert ra.unmasked_packed_fwd.launches == n7 + 1
    want = fa.flash_mha_packed_reference(q, k, v, HEADS)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,l,lk", [(2, 128, 64), (2, 1024, 512)])
def test_bf16_packed_kernel_edge_cases(cuda, b, l, lk, case):
    """B10's tensor-core forward on separate q, k, v (one q block over
    one key tile, and a longer run of tiles) against the twin at the bf16
    bar."""
    q, k, v = edge_qkv(case, b, l, lk, D, cuda, seed=l + lk)
    n0 = fa.flash_mha_packed.launches
    got = fa.flash_mha_packed(q, k, v, HEADS)
    torch.cuda.synchronize()
    assert fa.flash_mha_packed.launches == n0 + 1
    want = fa.flash_mha_packed_reference(q, k, v, HEADS)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.cuda
def test_packed_kernel_gradient_matches_twin(cuda):
    ts = _card_qkv(cuda, torch.float32, 2, 512, seed=7)
    do = torch.randn(2, 512, D, device=cuda)
    a = [t.clone().requires_grad_() for t in ts]
    fa.flash_mha_packed(*a, HEADS).backward(do)
    p = [t.clone().requires_grad_() for t in ts]
    fa.flash_mha_packed_reference(*p, HEADS).backward(do)
    for x, y in zip(a, p):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l", [(2, 512), (2, 768), (3, 1024)])
def test_packed_dropout_kernels_match_twin(cuda, dtype, b, l):
    ts = _card_qkv(cuda, dtype, b, l, seed=l + 1)
    do = torch.randn(b, l, D, generator=torch.Generator().manual_seed(l)).to(
        cuda, dtype)
    seed = torch.tensor(99, device=cuda)
    xk = [t.clone().requires_grad_() for t in ts]
    xp = [t.clone().requires_grad_() for t in ts]
    n0, m0 = fa.packed_dropout_fwd.launches, fa.packed_dropout_bwd.launches
    got = fa.flash_mha_packed_dropout(*xk, seed, HEADS, RATE)
    gk = torch.autograd.grad(got, xk, do)
    torch.cuda.synchronize()
    assert (fa.packed_dropout_fwd.launches, fa.packed_dropout_bwd.launches) \
        == (n0 + 1, m0 + 1)
    want = fa.flash_mha_packed_dropout_reference(*xp, seed, HEADS, RATE)
    gp = torch.autograd.grad(want, xp, do)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    for a, c in zip(gk, gp):
        rel = (a.float() - c.float()).norm() / c.float().norm()
        assert rel < (1e-5 if dtype == torch.float32 else 1e-2), rel
    again = fa.flash_mha_packed_dropout(*ts, 99, HEADS, RATE)
    assert torch.equal(again, got.detach())
    assert not torch.equal(fa.flash_mha_packed_dropout(*ts, 98, HEADS, RATE),
                           again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,l", [(2, 128), (2, 1024)])
def test_bf16_packed_dropout_kernels_edge_cases(cuda, b, l, case):
    """B11's bf16 tensor-core kernels, forward and backward, at the edge
    cases of tests/torch_attention_cases.py (one q block over two key
    tiles, and a longer run): against their rounding model to MODEL_REL,
    and against the twin at the bf16 bars (dq, dk and dv each 1e-2
    norm-relative), peaked softmax ("rising", "x16") included. For
    "odd" the operands are views at odd offsets of one leaf buffer, so the
    backward runs the 2-byte copy variant too."""
    ts = edge_qkv(case, b, l, l, D, cuda, seed=l + 3)
    do = torch.randn(b, l, D, generator=torch.Generator().manual_seed(l)).to(
        cuda, torch.bfloat16)
    buf = torch.cat([torch.zeros_like(ts[0][..., :1]), *ts],
                    -1).requires_grad_()
    xk = [buf[..., 1 + i * D:1 + (i + 1) * D] for i in range(3)]
    if case != "odd":
        xk = [t.detach().clone().requires_grad_() for t in ts]
    xp = [t.detach().clone().requires_grad_() for t in ts]
    got = fa.flash_mha_packed_dropout(*xk, 7, HEADS, RATE)
    gk = torch.autograd.grad(got, buf if case == "odd" else xk, do)
    if case == "odd":
        gk = [gk[0][..., 1 + i * D:1 + (i + 1) * D] for i in range(3)]
    want = fa.flash_mha_packed_dropout_reference(*xp, 7, HEADS, RATE)
    gp = torch.autograd.grad(want, xp, do)
    o, *gm = dropout_rounding_model(*ts, do, 7, HEADS, RATE)
    for a, c in zip((got, *gk), (o, *gm)):
        rel = (a.float() - c.float()).norm() / c.float().norm()
        assert rel <= MODEL_REL, rel
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
    for a, c in zip(gk, gp):
        rel = (a.float() - c.float()).norm() / c.float().norm()
        assert rel < 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_buffer_kernels_equal_split_kernels(cuda, dtype):
    """B4 is B11's kernels on column slices of one buffer: the same output
    and gradients, bit for bit."""
    ts = _card_qkv(cuda, dtype, 2, 512, seed=11)
    do = torch.randn(2, 512, D, device=cuda).to(dtype)
    xs = [t.clone().requires_grad_() for t in ts]
    xf = torch.cat(ts, -1).requires_grad_()
    split = fa.flash_mha_packed_dropout(*xs, 5, HEADS, RATE)
    fused = fa.flash_mha_qkv_packed_dropout(xf, 5, HEADS, RATE)
    split.backward(do)
    fused.backward(do)
    assert torch.equal(split, fused)
    assert torch.equal(xf.grad, torch.cat([t.grad for t in xs], -1))


@pytest.mark.cuda
def test_packed_dropout_rejects_what_it_cannot_take(cuda):
    q, k, v = _card_qkv(cuda, torch.float32, 2, 512)
    with pytest.raises(TypeError):
        fa.flash_mha_packed_dropout(q.half(), k, v, 1, HEADS, RATE)
    with pytest.raises(ValueError):
        fa.flash_mha_packed_dropout(q, k, v, 1, 2, RATE)        # head width 64
    with pytest.raises(ValueError):
        fa.flash_mha_packed_dropout(q[:, :500], k[:, :500], v[:, :500], 1,
                                    HEADS, RATE)               # L % 128
    with pytest.raises(ValueError):
        fa.flash_mha_packed_dropout(q, k[:, :256], v[:, :256], 1, HEADS,
                                    RATE)                      # Lq != Lkv
    with pytest.raises(ValueError):                            # images
        fa.flash_mha_packed_dropout(                           # interleaved
            torch.randn(512, 2, D, device=cuda).transpose(0, 1), k, v, 1,
            HEADS, RATE)
