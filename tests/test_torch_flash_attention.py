"""The port's hash-dropout attention over fused qkv (fudanocr_tpu_torch/ops/
flash_attention.py) and its multi-head attention module (nn/attention.py)
against the JAX package on the CPU, on the same seeded numpy inputs:

* the keep mask equals `dropout_keep_oracle` bit for bit;
* the output and dqkv equal the JAX Pallas kernels' (interpret mode) and
  `jax.grad` through their custom VJP, at the JAX tests' bars
  (tests/test_flash_attention.py: 2e-3 forward, 5e-3 gradients);
* the module's self, masked, cross and map-override paths equal the JAX
  module's in fp32, and its train route goes through the dropout op.

Tests marked `cuda` hold the hand-written kernels against the plain
version on the card (the bf16 tensor-core kernels and the fp32 split-TF32
ones also at the edge cases of tests/torch_attention_cases.py) and skip
where there is none. The JAX
package is imported inside the tests that use it, so the `cuda` tests
also run where jax is not installed:

    python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.nn.attention import MultiHeadAttention
from fudanocr_tpu_torch.ops import flash_attention as fa
from torch_attention_cases import (CASES, dropout_rounding_model,
                                   edge_qkv, edge_qkv_fused)

HEADS, RATE = 4, 0.1
FWD_TOL, GRAD_TOL = 2e-3, 5e-3   # tests/test_flash_attention.py:89,111
MODULE_ATOL = 2e-5               # fp32 module parity, same math both sides
# the bf16 kernels against their rounding model: the same rounding points,
# another summation order, and the card's exponential (2^x of one FMA with
# scale * log2(e) folded in, where the model rounds s * scale first), so a
# few bf16 outputs differ by one unit in the last place
MODEL_REL = 2e-3


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.fixture
def jx():
    """(jax, jax.numpy, the JAX flash_attention module)."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import flash_attention as jfa

    return jax, jax.numpy, jfa


@pytest.mark.parametrize("seed", [1234, 2 ** 32 - 1])
def test_keep_mask_matches_jax_oracle(jx, seed):
    _, jnp, jfa = jx
    want = np.asarray(jfa.dropout_keep_oracle(2, HEADS, 512, jnp.uint32(seed),
                                              RATE))
    got = fa.dropout_keep_oracle(2, HEADS, 512, seed, RATE).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - RATE)) < 5e-3
    assert fa.thresh(RATE) == int(jfa._thresh(RATE))


@pytest.mark.parametrize("l", [512, 768])
def test_dropout_attention_matches_jax(jx, l):
    jax, jnp, jfa = jx
    rng = np.random.default_rng(l)
    qkv = rng.standard_normal((2, l, 3 * HEADS * 32)).astype(np.float32)
    w = rng.standard_normal((2, l, HEADS * 32)).astype(np.float32)
    seed = 77

    def jloss(x):
        return jnp.sum(jfa.flash_mha_qkv_packed_dropout(
            x, jnp.uint32(seed), HEADS, RATE) * w)

    want = np.asarray(jfa.flash_mha_qkv_packed_dropout(
        jnp.asarray(qkv), jnp.uint32(seed), HEADS, RATE))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_()
    got = fa.flash_mha_qkv_packed_dropout(x, seed, HEADS, RATE)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def test_seed_decides_the_output():
    qkv = torch.randn(1, 512, 3 * 64, generator=torch.Generator()
                      .manual_seed(0))
    a = fa.flash_mha_qkv_packed_dropout(qkv, 5, 2, RATE)
    assert torch.equal(a, fa.flash_mha_qkv_packed_dropout(
        qkv, torch.tensor(5), 2, RATE))
    assert not torch.equal(a, fa.flash_mha_qkv_packed_dropout(qkv, 6, 2,
                                                              RATE))
    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed_dropout(qkv, 2 ** 32, 2, RATE)


# -- the module ----------------------------------------------------------


def _jax_mha(jx, rng, d, heads, q_in, kv_in, self_attn):
    jax, jnp, _ = jx
    from fudanocr_tpu.nn.attention import MultiHeadAttention as JaxMHA

    m = JaxMHA(num_heads=heads, d_model=d)
    q = jnp.asarray(q_in)
    kv = q if self_attn else jnp.asarray(kv_in)
    v = m.init(jax.random.PRNGKey(0), q, kv, kv)
    v = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), v)
    return m, v, q, kv


def _port_mha(variables, d, heads, kv_features=None):
    p = variables["params"]
    if "qkv" in p:
        k, b = p["qkv"]["kernel"], p["qkv"]["bias"]
        ws = [(k[:, i * d:(i + 1) * d], b[i * d:(i + 1) * d])
              for i in range(3)]
    else:
        kv, bkv = p["kv"]["kernel"], p["kv"]["bias"]
        ws = [(p["q"]["kernel"], p["q"]["bias"]), (kv[:, :d], bkv[:d]),
              (kv[:, d:], bkv[d:])]
    ws.append((p["out"]["kernel"], p["out"]["bias"]))
    m = MultiHeadAttention(heads, d, kv_features=kv_features)
    sd = {}
    for i, (k, b) in enumerate(ws):
        sd[f"linears.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(k).T))
        sd[f"linears.{i}.bias"] = torch.from_numpy(np.asarray(b))
    m.load_state_dict(sd)
    return m


def test_masked_self_attention_matches_jax(jx):
    """The oracle decoder's causal self-attention, with maps."""
    _, jnp, _ = jx
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    jm, v, xq, _ = _jax_mha(jx, rng, 64, 4, x, None, True)
    mask = np.tril(np.ones((12, 12), bool))[None, None]
    want, want_p = jm.apply(v, xq, xq, xq, mask=jnp.asarray(mask))
    m = _port_mha(v, 64, 4)
    xt = torch.from_numpy(x)
    got, got_p = m(xt, xt, xt, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=MODULE_ATOL)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=MODULE_ATOL)


def test_cross_attention_and_map_override_match_jax(jx):
    """The oracle's cross-attention over wider memory tokens: output and
    map, then the same layer with the map given (attention_map=)."""
    _, jnp, _ = jx
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 20, 48)).astype(np.float32)
    jm, v, xq, jmem = _jax_mha(jx, rng, 32, 4, x, mem, False)
    want, want_p = jm.apply(v, xq, jmem, jmem)
    m = _port_mha(v, 32, 4, kv_features=48)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mem)
    got, got_p = m(xt, mt, mt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=MODULE_ATOL)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=MODULE_ATOL)
    amap = rng.random((2, 4, 6, 20)).astype(np.float32)
    want2, _ = jm.apply(v, xq, jmem, jmem, attention_map=jnp.asarray(amap))
    got2, _ = m(xt, mt, mt, attention_map=torch.from_numpy(amap))
    np.testing.assert_allclose(got2.detach().numpy(), np.asarray(want2),
                               rtol=1e-5, atol=MODULE_ATOL)


def test_train_route_is_the_dropout_op():
    """Train-mode self-attention of a `use_flash` module (TBSRN's
    enhancer) at a supported shape runs the packed dropout op with one
    seed drawn from the generator; kernels=False runs the plain version on
    the same route; maps or a mask take the plain path, whose dropout also
    draws from the generator."""
    torch.manual_seed(0)
    m = MultiHeadAttention(4, 128, use_flash=True)
    x = torch.randn(2, 512, 128)
    g = torch.Generator().manual_seed(3)
    got, probs = m(x, x, x, deterministic=False, need_weights=False,
                   generator=g)
    assert probs is None
    seed = torch.randint(0, 2 ** 32, (), generator=torch.Generator()
                         .manual_seed(3), dtype=torch.int64)
    w = torch.cat([lin.weight for lin in m.linears[:3]])
    b = torch.cat([lin.bias for lin in m.linears[:3]])
    qkv = torch.nn.functional.linear(x, w, b)
    want = m.linears[3](fa.flash_mha_qkv_packed_dropout_reference(
        qkv, seed, 4, m.dropout_rate))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    m.kernels = False
    again, _ = m(x, x, x, deterministic=False, need_weights=False,
                 generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    a, pa = m(x, x, x, deterministic=False,
              generator=torch.Generator().manual_seed(4))
    kept = (pa > 0).float().mean().item()
    assert abs(kept - (1 - m.dropout_rate)) < 5e-3
    b2, _ = m(x, x, x, deterministic=False,
              generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b2, rtol=0, atol=0)


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,l", [(2, 4, 512), (3, 2, 768)])
def test_kernel_keep_mask_is_the_plain_hash(cuda, b, heads, l):
    for seed in (0, 12345, 2 ** 32 - 1):
        got = fa.dropout_keep_mask_cuda(seed, b, heads, l, RATE, cuda)
        want = fa.dropout_keep_oracle(b, heads, l, seed, RATE)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,l", [(2, 4, 512), (2, 4, 768),
                                       (3, 2, 1024)])
def test_kernels_match_plain_version(cuda, dtype, b, heads, l):
    gen = torch.Generator().manual_seed(l + heads)
    qkv = torch.randn(b, l, 3 * heads * 32, generator=gen).to(cuda, dtype)
    do = torch.randn(b, l, heads * 32, generator=gen).to(cuda, dtype)
    seed = torch.tensor(99, device=cuda)
    xk, xp = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    n0, m0 = fa.qkv_dropout_fwd.launches, fa.qkv_dropout_bwd.launches
    got = fa.flash_mha_qkv_packed_dropout(xk, seed, heads, RATE)
    (dk,) = torch.autograd.grad(got, xk, do)
    torch.cuda.synchronize()
    assert (fa.qkv_dropout_fwd.launches, fa.qkv_dropout_bwd.launches) == (
        n0 + 1, m0 + 1)
    want = fa.flash_mha_qkv_packed_dropout_reference(xp, seed, heads, RATE)
    (dp,) = torch.autograd.grad(want, xp, do)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    rel = (dk.float() - dp.float()).norm() / dp.float().norm()
    assert rel < (1e-5 if dtype == torch.float32 else 1e-2), rel
    again = fa.flash_mha_qkv_packed_dropout(qkv, 99, heads, RATE)
    assert torch.equal(again, got.detach())
    assert not torch.equal(
        fa.flash_mha_qkv_packed_dropout(qkv, 98, heads, RATE), again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,heads,l", [(2, 4, 128), (2, 4, 1024),
                                       (1, 2, 768)])
def test_bf16_kernels_edge_cases(cuda, b, heads, l, case):
    """The bf16 tensor-core kernels, forward and backward, at the edge
    cases of tests/torch_attention_cases.py: against their rounding model
    (`dropout_rounding_model`) to MODEL_REL, the output against the plain
    version at the bf16 bar (2e-2), and dqkv against it at its bar (1e-2
    norm-relative), also at "rising" and "x16", where the softmax is peaked
    and dS = P (dP - D) cancels (the kernels form D in fp32, as JAX and the
    plain version do). For "odd" qkv is a view at an odd offset of a leaf
    buffer, which rules out 16-byte copies in both kernels."""
    x = edge_qkv_fused(case, b, l, heads * 32, cuda, seed=l + heads)
    do = torch.randn(b, l, heads * 32, generator=torch.Generator()
                     .manual_seed(l)).to(cuda, torch.bfloat16)
    buf = torch.cat([torch.zeros_like(x[..., :1]), x], -1).requires_grad_()
    xk = buf[..., 1:] if case == "odd" else x.detach().clone()
    xk = xk if case == "odd" else xk.requires_grad_()
    xp = x.detach().clone().requires_grad_()
    got = fa.flash_mha_qkv_packed_dropout(xk, 7, heads, RATE)
    (dk,) = torch.autograd.grad(got, buf if case == "odd" else xk, do)
    dk = dk[..., 1:] if case == "odd" else dk
    want = fa.flash_mha_qkv_packed_dropout_reference(xp, 7, heads, RATE)
    (dp,) = torch.autograd.grad(want, xp, do)
    o, *grads = dropout_rounding_model(*fa._columns(x), do, 7, heads, RATE)
    assert _rel(got, o) <= MODEL_REL, _rel(got, o)
    assert _rel(dk, torch.cat(grads, -1)) <= MODEL_REL
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel(dk, dp) < 1e-2, _rel(dk, dp)


def _fp32_edge_operands(case: str, b: int, heads: int, l: int, dev):
    """fp32 qkv (B, L, 3D) of the edge case on the CPU, and dO on `dev`
    (uniform in [-8, 8] for "large", as v)."""
    d = heads * 32
    q, k, v = edge_qkv(case, b, l, l, d, "cpu", seed=l + heads,
                       dtype=torch.float32)
    gen = torch.Generator().manual_seed(l)
    do = (16 * torch.rand(b, l, d, generator=gen) - 8 if case == "large"
          else torch.randn(b, l, d, generator=gen))
    return torch.cat([q, k, v], -1), do.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv", "qkv_odd", "split_odd"])
@pytest.mark.parametrize("case", ["plain", "peaked", "large"])
@pytest.mark.parametrize("b,heads,l", [(2, 4, 128), (2, 4, 1024)])
def test_fp32_kernels_edge_cases(cuda, b, heads, l, case, layout):
    """The fp32 split-TF32 kernels, forward and backward, against the plain
    version at the fp32 bars (1e-5: the output at rtol = atol, dq, dk and dv
    each norm-relative) on standard normals, a peaked softmax (|s| ~ 30)
    and v, dO of magnitude up to 8, at L = 128 (the smallest L taken, two
    key tiles) and 1024. Layouts: B4 on a whole qkv buffer; B4 on qkv as a
    column slice of a wider buffer at an odd offset; B11 on q, k, v as such
    slices, each base one float off 16 bytes at an odd row stride (both
    rule out the 16-byte copies). The kernels' keep mask is the plain
    hash's, bit for bit."""
    d = heads * 32
    qkv, do = _fp32_edge_operands(case, b, heads, l, cuda)
    n0 = (fa.qkv_dropout_fwd.launches, fa.qkv_dropout_bwd.launches,
          fa.packed_dropout_fwd.launches, fa.packed_dropout_bwd.launches)
    if layout == "qkv":
        x = qkv.to(cuda).requires_grad_()
        got = fa.flash_mha_qkv_packed_dropout(x, 11, heads, RATE)
        (g,) = torch.autograd.grad(got, x, do)
    else:
        buf = torch.cat([torch.zeros(b, l, 1), qkv], -1).to(cuda)
        buf.requires_grad_()
        if layout == "qkv_odd":
            got = fa.flash_mha_qkv_packed_dropout(buf[..., 1:], 11, heads,
                                                  RATE)
        else:
            xs = [buf[..., 1 + i * d:1 + (i + 1) * d] for i in range(3)]
            assert all(t.data_ptr() % 16 == 4 for t in xs)
            got = fa.flash_mha_packed_dropout(*xs, 11, heads, RATE)
        (g,) = torch.autograd.grad(got, buf, do)
        g = g[..., 1:]
    torch.cuda.synchronize()
    n1 = (fa.qkv_dropout_fwd.launches, fa.qkv_dropout_bwd.launches,
          fa.packed_dropout_fwd.launches, fa.packed_dropout_bwd.launches)
    split = layout == "split_odd"
    assert [b_ - a_ for a_, b_ in zip(n0, n1)] == (
        [0, 0, 1, 1] if split else [1, 1, 0, 0])
    xp = qkv.to(cuda).requires_grad_()
    want = fa.flash_mha_qkv_packed_dropout_reference(xp, 11, heads, RATE)
    (gp,) = torch.autograd.grad(want, xp, do)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for i, name in enumerate(("dq", "dk", "dv")):
        cols = slice(i * d, (i + 1) * d)
        assert _rel(g[..., cols], gp[..., cols]) <= 1e-5, name
    keep = fa.dropout_keep_mask_cuda(11, b, heads, l, RATE, cuda)
    assert torch.equal(keep.cpu(), fa.dropout_keep_oracle(b, heads, l, 11,
                                                          RATE))


@pytest.mark.cuda
def test_fp32_split_wrapper_rejects_what_it_cannot_take(cuda):
    q = torch.randn(2, 512, 128, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_mha_packed_dropout(q, q, q, 1, 2, RATE)        # head width 64
    q = q[:, :200].contiguous()
    with pytest.raises(ValueError):
        fa.flash_mha_packed_dropout(q, q, q, 1, 4, RATE)        # L % 128


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    qkv = torch.randn(2, 512, 384, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_mha_qkv_packed_dropout(qkv.half(), 1, 4, RATE)
    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed_dropout(qkv, 1, 2, RATE)        # head width 64
    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed_dropout(qkv[:, :500].contiguous(), 1, 4,
                                        RATE)                   # L % 128
    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed_dropout(qkv.transpose(0, 1), 1, 4, RATE)
