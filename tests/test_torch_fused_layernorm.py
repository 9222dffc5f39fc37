"""The port's fused residual LayerNorm (fudanocr_tpu_torch/ops/
fused_layernorm.py) against the JAX package's `fused_residual_layernorm`
(its Pallas kernel in interpret mode on the CPU, and its custom VJP) on
the same seeded numpy inputs: values and gradients.

Tests marked `cuda` hold the hand-written kernel against the plain version
on the card and skip where there is none. The JAX package is imported
inside the tests that use it, so the `cuda` tests also run where jax is
not installed:

    python -m pytest tests/test_torch_fused_layernorm.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.nn.layers import TorchLayerNorm
from fudanocr_tpu_torch.ops.fused_layernorm import (
    fused_residual_layernorm, fused_residual_layernorm_reference)

ROWS, D = 256, 128
FP32_ATOL = 1e-5     # both sides compute in fp32; sums differ in order
BF16_ATOL = 0.04     # ~5 bf16 ulps at |y| <= 4 (the output is rounded)


@pytest.fixture
def jx():
    """(jax, jax.numpy, the JAX fused_residual_layernorm)."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops.fused_layernorm import fused_residual_layernorm

    return jax, jax.numpy, fused_residual_layernorm


def _inputs(rng, rows=ROWS, d=D):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    res = rng.standard_normal((rows, d)).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, res, scale, bias


def _torch(*arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad)
            for a in arrays]


@pytest.mark.parametrize("via", ["wrapper", "reference"])
def test_forward_and_grads_match_jax(jx, via):
    """Forward and the gradients of a weighted sum in x, res, scale, bias:
    the wrapper (plain forward + closed-form backward on the CPU) and the
    plain version under autograd, both against JAX's kernel and VJP."""
    jax, jnp, jfn = jx
    rng = np.random.default_rng(0)
    x, res, scale, bias = _inputs(rng)
    w = rng.standard_normal((ROWS, D)).astype(np.float32)

    def jloss(x, res, scale, bias):
        return jnp.sum(jfn(x, res, scale, bias) * w)

    want = np.asarray(jfn(*map(jnp.asarray, (x, res, scale, bias))))
    want_g = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, res, scale, bias)))
    fn = (fused_residual_layernorm if via == "wrapper"
          else fused_residual_layernorm_reference)
    tx, tr, ts, tb = _torch(x, res, scale, bias, requires_grad=True)
    got = fn(tx, tr, ts, tb)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FP32_ATOL)
    for t, g in zip((tx, tr, ts, tb), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=FP32_ATOL)


def test_bf16_matches_jax(jx):
    """bf16 in and out, fp32 statistics: within a few bf16 ulps of the
    JAX kernel's bf16 output."""
    _, jnp, jfn = jx
    x, res, scale, bias = _inputs(np.random.default_rng(1))
    want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(res, jnp.bfloat16), jnp.asarray(scale),
                          jnp.asarray(bias)), np.float32)
    tx, tr, ts, tb = _torch(x, res, scale, bias)
    got = fused_residual_layernorm(tx.bfloat16(), tr.bfloat16(), ts, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_ATOL)


def test_module_routes_through_the_op():
    """TorchLayerNorm(x, residual) is the op (kernels=True) or its plain
    version (kernels=False); both equal on the CPU."""
    x, res, scale, bias = _torch(*_inputs(np.random.default_rng(2), 8, 32))
    m = TorchLayerNorm(32)
    with torch.no_grad():
        m.a_2.copy_(scale)
        m.b_2.copy_(bias)
    want = fused_residual_layernorm_reference(x, res, scale, bias)
    torch.testing.assert_close(m(x, res), want, rtol=0, atol=0)
    m.kernels = False
    torch.testing.assert_close(m(x, res), want, rtol=0, atol=0)


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64 * 1024, 128), (64 * 32, 1024),
                                    (37, 77), (5, 2048), (3, 33)])
def test_kernel_matches_plain_version(cuda, dtype, rows, d):
    """Forward, and the gradients through the Function against plain
    autograd. (At D = 2 the normalised output is +-1/sqrt(2) whatever the
    input, so its input gradient is rounding noise: not a useful case.)"""
    gen = torch.Generator().manual_seed(rows + d)
    x, res = (torch.randn(rows, d, generator=gen).to(cuda, dtype)
              .requires_grad_() for _ in range(2))
    scale = (1 + 0.2 * torch.randn(d, generator=gen)).to(cuda)
    bias = (0.1 * torch.randn(d, generator=gen)).to(cuda)
    scale.requires_grad_()
    bias.requires_grad_()
    g = torch.randn(rows, d, generator=gen).to(cuda, dtype)
    n0 = fused_residual_layernorm.launches
    got = fused_residual_layernorm(x, res, scale, bias)
    torch.cuda.synchronize()
    assert fused_residual_layernorm.launches == n0 + 1
    want = fused_residual_layernorm_reference(x, res, scale, bias)
    atol = 1e-5 if dtype == torch.float32 else BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    gk = torch.autograd.grad(got, (x, res, scale, bias), g)
    gp = torch.autograd.grad(want, (x, res, scale, bias), g)
    for a, b in zip(gk, gp):
        err = (a.float() - b.float()).norm() / b.float().norm().clamp_min(
            1e-12)
        assert err < (1e-5 if dtype == torch.float32 else 1e-2), err


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    x = torch.randn(4, 128, device=cuda)
    s, b = torch.ones(128, device=cuda), torch.zeros(128, device=cuda)
    with pytest.raises(TypeError):
        fused_residual_layernorm(x.half(), x.half(), s, b)
    with pytest.raises(ValueError):
        fused_residual_layernorm(x, x.bfloat16(), s, b)
    with pytest.raises(ValueError):
        fused_residual_layernorm(x.t(), x.t(), s[:4], b[:4])
    with pytest.raises(ValueError):
        fused_residual_layernorm(x, x, s.double(), b)
    big = torch.randn(2, 4096, device=cuda)
    with pytest.raises(ValueError):
        fused_residual_layernorm(big, big, torch.ones(4096, device=cuda),
                                 torch.zeros(4096, device=cuda))
