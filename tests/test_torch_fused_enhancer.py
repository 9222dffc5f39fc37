"""The port's fused enhancer (fudanocr_tpu_torch/ops/fused_enhancer.py)
against the JAX package's FeatureEnhancer: the unfused module chain and
the Pallas kernel (`fuse="force"`, interpret mode on the CPU), both fed the
same seeded numpy inputs and weights, compared in fp32.

Tests marked `cuda` hold the hand-written kernel against the plain version
on the card and skip where there is none. The JAX package is imported
inside the tests that use it, so the `cuda` tests also run where jax is
not installed:

    python -m pytest tests/test_torch_fused_enhancer.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.models.sr.tbsrn import FeatureEnhancer
from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
from fudanocr_tpu_torch.ops.fused_enhancer import (enhancer_operands,
                                                   fused_enhancer,
                                                   fused_enhancer_reference)

B, H, W, C = 2, 8, 64, 64      # L = 512, the JAX kernel's minimum
RTOL, ATOL = 2e-4, 2e-5        # the JAX kernel's fp32 bar (test_fused_enhancer)


@pytest.fixture
def jx():
    """(jax, jax.numpy, the JAX FeatureEnhancer)."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.models.sr.tbsrn import FeatureEnhancer as JaxEnhancer

    return jax, jax.numpy, JaxEnhancer


def _tokens(rng, b=B, l=H * W):
    return (rng.standard_normal((b, l, C)) * 0.5).astype(np.float32)


def _jax_variables(jx, rng):
    """FeatureEnhancer variables with every weight random (LN scales away
    from 1), as nested dicts of numpy arrays."""
    jax, jnp, JaxEnhancer = jx
    v = JaxEnhancer(height=H, width=W).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H * W, C)))
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * (0.5 if a.ndim == 1
                                                   else a.shape[0] ** -0.5)
                   + (1.0 if a.ndim == 1 else 0.0)).astype(np.float32), v)


def _port_params(variables):
    """The JAX param tree in the port's (in, out) operand layout."""
    p = variables["params"]
    return {"wqkv": p["mha"]["qkv"]["kernel"], "bqkv": p["mha"]["qkv"]["bias"],
            "wout": p["mha"]["out"]["kernel"], "bout": p["mha"]["out"]["bias"],
            "ln1_scale": p["ln1"]["scale"], "ln1_bias": p["ln1"]["bias"],
            "w1": p["pff_w1"]["kernel"], "b1": p["pff_w1"]["bias"],
            "w2": p["pff_w2"]["kernel"], "b2": p["pff_w2"]["bias"],
            "ln2_scale": p["ln2"]["scale"], "ln2_bias": p["ln2"]["bias"],
            "wp": p["proj"]["kernel"], "bp": p["proj"]["bias"]}


def _pe(h, w):
    return torch.from_numpy(
        positional_encoding_2d(64, h, w).reshape(64, h * w).T.copy())


def _port_reference(variables, x, h=H, w=W):
    params = {k: torch.from_numpy(np.asarray(v))
              for k, v in _port_params(variables).items()}
    ops = enhancer_operands(params, _pe(h, w), torch.float32)
    return fused_enhancer_reference(torch.from_numpy(x), ops).numpy()


@pytest.mark.parametrize("fuse", [False, "force"])
def test_reference_matches_jax_enhancer(jx, fuse):
    """The plain version against the JAX unfused chain and the JAX Pallas
    kernel (interpret mode) on the same tokens and weights."""
    _, jnp, JaxEnhancer = jx
    rng = np.random.default_rng(0)
    variables = _jax_variables(jx, rng)
    x = _tokens(rng)
    want = np.asarray(JaxEnhancer(height=H, width=W, fuse=fuse).apply(
        variables, jnp.asarray(x)))
    np.testing.assert_allclose(_port_reference(variables, x), want,
                               rtol=RTOL, atol=ATOL)


def test_reference_matches_jax_at_ragged_length(jx):
    """L = 35 (5x7): below the JAX kernel's envelope, so against the JAX
    unfused chain only; the port's kernel masks the ragged tiles."""
    _, jnp, JaxEnhancer = jx
    rng = np.random.default_rng(1)
    variables = _jax_variables(jx, rng)
    x = _tokens(rng, l=35)
    want = np.asarray(JaxEnhancer(height=5, width=7).apply(
        variables, jnp.asarray(x)))
    np.testing.assert_allclose(_port_reference(variables, x, 5, 7), want,
                               rtol=RTOL, atol=ATOL)


def test_module_weights_map_to_jax_layout(jx):
    """FeatureEnhancer keeps the reference's four MHA linears; its
    kernel_params() must be the JAX fused layout, so the module's output
    equals the JAX module's on the same weights."""
    torch.manual_seed(0)
    m = FeatureEnhancer().eval()
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    _, jnp, JaxEnhancer = jx
    kp = {k: v.detach().numpy() for k, v in m.kernel_params().items()}
    params = {
        "mha": {"qkv": {"kernel": kp["wqkv"], "bias": kp["bqkv"]},
                "out": {"kernel": kp["wout"], "bias": kp["bout"]}},
        "ln1": {"scale": kp["ln1_scale"], "bias": kp["ln1_bias"]},
        "pff_w1": {"kernel": kp["w1"], "bias": kp["b1"]},
        "pff_w2": {"kernel": kp["w2"], "bias": kp["b2"]},
        "ln2": {"scale": kp["ln2_scale"], "bias": kp["ln2_bias"]},
        "proj": {"kernel": kp["wp"], "bias": kp["bp"]}}
    x = _tokens(np.random.default_rng(2))
    want = np.asarray(JaxEnhancer(height=H, width=W).apply(
        {"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = m(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_operand_cache_follows_weight_updates():
    """Cached operands are rebuilt after an in-place weight change."""
    m = FeatureEnhancer().eval()
    x = torch.randn(1, 32, C)
    with torch.inference_mode():
        before = m(x, 4, 8)
    with torch.no_grad():
        m.linear.bias.add_(1.0)
    with torch.inference_mode():
        after = m(x, 4, 8)
    torch.testing.assert_close(after, before + 1.0, rtol=0, atol=1e-5)


def test_bf16_reference_rounds_like_jax_kernel(jx):
    """bf16 activations: the plain version rounds at the JAX kernel's
    sublayer boundaries, so it agrees with the JAX kernel within the JAX
    test's bf16 bars (test_fused_enhancer.py:50-51)."""
    _, jnp, JaxEnhancer = jx
    rng = np.random.default_rng(3)
    variables = _jax_variables(jx, rng)
    x = _tokens(rng)
    want = np.asarray(JaxEnhancer(height=H, width=W, dtype=jnp.bfloat16,
                                  fuse="force").apply(
        variables, jnp.asarray(x, jnp.bfloat16)), np.float32)
    params = {k: torch.from_numpy(np.asarray(v))
              for k, v in _port_params(variables).items()}
    ops = enhancer_operands(params, _pe(H, W), torch.bfloat16)
    got = fused_enhancer_reference(
        torch.from_numpy(x).to(torch.bfloat16), ops).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    assert float(np.mean(np.abs(got - want))) < 0.01


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_ops(gen, dtype, h, w, device):
    d = 128
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wout": (d, d),
              "bout": (d,), "ln1_scale": (d,), "ln1_bias": (d,),
              "w1": (d, d), "b1": (d,), "w2": (d, d), "b2": (d,),
              "ln2_scale": (d,), "ln2_bias": (d,), "wp": (d, 64), "bp": (64,)}
    params = {k: (torch.randn(*s, generator=gen) * (0.2 if len(s) == 1
                                                    else d ** -0.5)
                  + (1.0 if "scale" in k else 0.0)).to(device)
              for k, s in shapes.items()}
    return enhancer_operands(params, _pe(h, w).to(device), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,heads", [
    (2, 5, 7, 4), (3, 16, 50, 2), (4, 16, 64, 4),
    # L = 1000: a partial last K/V tile (1000 = 15 * 64 + 40)
    (2, 20, 50, 4), (2, 20, 50, 2)])
@pytest.mark.parametrize("peaked", [False, True])
def test_kernel_matches_plain_version(cuda, dtype, b, h, w, heads, peaked):
    """`peaked`: the tokens scaled x4, so that the scores are large and a
    row's max moves from K/V tile to tile (the online rescale by alpha)."""
    gen = torch.Generator().manual_seed(b * h * w)
    ops = _random_ops(gen, dtype, h, w, cuda)
    x = (torch.randn(b, h * w, C, generator=gen) * (2.0 if peaked else 0.5)
         ).to(cuda, dtype)
    n0 = fused_enhancer.launches
    got = fused_enhancer(x, ops, heads=heads).float()
    torch.cuda.synchronize()
    assert fused_enhancer.launches == n0 + 2
    want = fused_enhancer_reference(x, ops, heads=heads).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert (got - want).abs().max() < 0.05
        assert (got - want).abs().mean() < 0.01


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    gen = torch.Generator().manual_seed(0)
    ops = _random_ops(gen, torch.float32, 4, 8, cuda)
    x = torch.randn(2, 32, C, device=cuda)
    with pytest.raises(ValueError):
        fused_enhancer(x.transpose(0, 1).contiguous().transpose(0, 1), ops)
    with pytest.raises(TypeError):
        fused_enhancer(x.half(), ops)
    with pytest.raises(ValueError):
        fused_enhancer(x.bfloat16(), ops)   # operands are fp32
    with pytest.raises(ValueError):
        fused_enhancer(x, ops, heads=8)     # head width 16
