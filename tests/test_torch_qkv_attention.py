"""The port's packed-qkv attention without dropout (fudanocr_tpu_torch/ops/
flash_attention.py `flash_mha_qkv_packed`, B3), the `use_flash` routes of
nn/attention.py, and TBSRN's unfused inference (`fused_enhancer=False`)
against the JAX package on the CPU, on the same seeded numpy inputs:

* the B3 twin equals the JAX Pallas kernel `flash_mha_qkv_packed` run in
  interpret mode at L 512, D 128, 4 heads: fp32 atol 1e-5, and bf16 with
  the same bf16 operands at 2e-2 (both sides round the probabilities to
  bf16 for the value product and the output to bf16: a few bf16 ulps of
  outputs of magnitude ~1), also at 2 heads of 64;
* the port's gates equal the JAX gates (`flash_attention_supported`,
  `fused_enhancer_supported`) on a grid of shapes;
* the routes: a module without `use_flash` reaches no kernel wrapper
  whatever the shape (the fault this file guards against); a `use_flash`
  module takes the dropout kernel (B4) in train mode, B3 at eval at L 512
  and the (B, H, L, dh) kernel (B5) at eval at L 2304, and `kernels=False`
  the twins on the same routes;
* TBSRN with `fused_enhancer=False` equals the JAX TBSRN with the same
  flag at LR 16x32 (L = 512) in fp32, atol 2e-4, through B3's twin.

Tests marked `cuda` hold the kernel against the twin on the card, the bf16
tensor-core forward also at its edge cases (tests/torch_attention_cases.py),
and skip where there is none; they import no jax:

    python -m pytest tests/test_torch_qkv_attention.py -m cuda --noconftest
"""

import itertools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.nn import attention
from fudanocr_tpu_torch.nn.attention import MultiHeadAttention
from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.ops import region_attention as ra
from fudanocr_tpu_torch.ops.fused_enhancer import fused_enhancer_supported
from torch_attention_cases import CASES, edge_qkv_fused
from torch_threads import one_torch_thread  # noqa: F401

HEADS, D = 4, 128
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import flash_attention as jfa
    return jax, jax.numpy, jfa


@pytest.mark.parametrize("dtype,heads", [
    pytest.param(torch.float32, HEADS, id="dtype0"),
    pytest.param(torch.bfloat16, HEADS, id="dtype1"),
    pytest.param(torch.bfloat16, 2, id="bf16-dh64")])
def test_qkv_twin_matches_jax_kernel(jx, dtype, heads):
    _, jnp, jfa = jx
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((2, 512, 3 * D)).astype(np.float32)
    t = torch.from_numpy(qkv).to(dtype)
    j = jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jfa.flash_mha_qkv_packed(j, heads).astype(jnp.float32))
    got = fa.flash_mha_qkv_packed(t, heads)
    assert got.dtype == dtype and got.shape == (2, 512, D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype])


def test_gates_match_jax(jx):
    _, _, jfa = jx
    from fudanocr_tpu.ops.fused_enhancer import \
        fused_enhancer_supported as jax_fe_supported

    n = 0
    for l, dh in itertools.product((128, 256, 500, 512, 768, 1024, 2048,
                                    2304, 4096), (8, 16, 32, 64, 128, 256)):
        shape = (2, 4, l, dh)
        assert fa.flash_attention_supported(shape) == \
            jfa.flash_attention_supported(shape), shape
        for d in (64, 128, 256, 384):
            assert fused_enhancer_supported(l, d, 4) == \
                jax_fe_supported(l, d, 4), (l, d)
        n += 1
    assert not fa.flash_attention_supported((4, 512, 32))
    assert n == 54


WRAPPERS = ("flash_mha_qkv_packed_dropout",
            "flash_mha_qkv_packed_dropout_reference", "flash_mha_qkv_packed",
            "flash_mha_qkv_packed_reference", "flash_mha",
            "flash_mha_reference")


@pytest.fixture
def calls(monkeypatch):
    """Records which kernel wrapper (or twin) nn/attention.py calls."""
    seen = []
    for name in WRAPPERS:
        real = getattr(attention, name)

        def spy(*a, _name=name, _real=real, **k):
            seen.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(attention, name, spy)
    return seen


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("l", [512, 2304])
def test_module_without_use_flash_reaches_no_kernel(calls, train, l):
    torch.manual_seed(0)
    m = MultiHeadAttention(HEADS, D)
    x = torch.randn(1, l, D)
    out, probs = m(x, x, x, deterministic=not train, need_weights=False,
                   generator=torch.Generator().manual_seed(1))
    assert calls == [] and probs is None and out.shape == x.shape


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("train,l,want", [
    (True, 512, "flash_mha_qkv_packed_dropout"),
    (False, 512, "flash_mha_qkv_packed"),
    (False, 2304, "flash_mha")])
def test_use_flash_routes(calls, kernels, train, l, want):
    """The routes of JAX nn/attention.py:102-146, and that each gives the
    module's plain path's function (dropout aside: in train mode the rate
    is 0.1 on the route and the plain path draws another mask, so the
    output is held to the twin run by hand)."""
    torch.manual_seed(0)
    m = MultiHeadAttention(HEADS, D, kernels=kernels, use_flash=True)
    x = torch.randn(1, l, D)
    out, probs = m(x, x, x, deterministic=not train, need_weights=False,
                   generator=torch.Generator().manual_seed(1))
    assert calls == [want if kernels else want + "_reference"]
    assert probs is None
    if not train:
        plain = MultiHeadAttention(HEADS, D)
        plain.load_state_dict(m.state_dict())
        calls.clear()
        ref, _ = plain(x, x, x, need_weights=False)
        assert calls == []
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_use_flash_keeps_the_plain_path_for_maps_masks_and_other_widths(
        calls):
    torch.manual_seed(0)
    m = MultiHeadAttention(HEADS, D, use_flash=True)
    x = torch.randn(1, 512, D)
    m(x, x, x)                                          # maps asked for
    m(x, x, x, mask=torch.ones(1, 1, 512, 512, dtype=torch.bool),
      need_weights=False)
    m(x, x, x, attention_map=torch.full((1, HEADS, 512, 512), 1 / 512),
      need_weights=False)
    wide = MultiHeadAttention(1, D, use_flash=True)     # dh 128: JAX's gates
    wide(x, x, x, need_weights=False)                  # admit it, B3 not
    assert calls == []


def test_tbsrn_unfused_matches_jax(jx, monkeypatch):
    """Eval with `fused_enhancer=False` at L = 512: every enhancer's
    attention through B3 (its twin here), its LayerNorms through the
    residual-LayerNorm op (B2's twin)."""
    jax, jnp, _ = jx
    from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN
    from fudanocr_tpu_torch.models.sr import TBSRN
    from fudanocr_tpu_torch.utils.weights import load_jax_variables

    srb = 2
    rng = np.random.default_rng(1)
    lr = rng.random((2, 16, 32, 3)).astype(np.float32)
    jm = JaxTBSRN(scale_factor=2, width=64, height=32, stn=False,
                  srb_nums=srb, hidden_units=32, fused_enhancer=False,
                  wide_out_block=0)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                                   jnp.asarray(lr)))
    for name, st in v["batch_stats"].items():
        for bn in st.values():
            bn["mean"] = (rng.standard_normal(bn["mean"].shape) * 0.1
                          ).astype(np.float32)
            bn["var"] = (rng.random(bn["var"].shape) * 0.5 + 0.75
                         ).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(lr)))
    seen = []
    real = attention.flash_mha_qkv_packed
    monkeypatch.setattr(attention, "flash_mha_qkv_packed",
                        lambda *a: seen.append(a[0].shape) or real(*a))
    m = load_jax_variables(TBSRN(width=64, stn=False, srb_nums=srb,
                                 fused_enhancer=False), "tbsrn", v,
                           srb_nums=srb, stn=False)
    with torch.inference_mode():
        got = m(torch.from_numpy(lr)).numpy()
    assert seen == [(2, 512, 3 * D)] * srb
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=ATOL)


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l", [(4, 512), (2, 1024), (1, 2048)])
def test_qkv_kernel_matches_twin(cuda, dtype, b, l):
    gen = torch.Generator().manual_seed(l)
    qkv = torch.randn(b, l, 3 * D, generator=gen).to(cuda, dtype)
    n0 = fa.flash_mha_qkv_packed.launches
    n7 = ra.unmasked_packed_fwd.launches
    got = fa.flash_mha_qkv_packed(qkv, HEADS)
    torch.cuda.synchronize()
    assert fa.flash_mha_qkv_packed.launches == n0 + 1
    assert ra.unmasked_packed_fwd.launches == n7 + 1
    want = fa.flash_mha_qkv_packed_reference(qkv, HEADS)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,l,heads", [(2, 1024, HEADS), (1, 512, 2)])
def test_bf16_qkv_kernel_edge_cases(cuda, b, l, heads, case):
    """The tensor-core forward on column slices of one qkv (dh 32 and
    64), against the twin at the bf16 bar."""
    qkv = edge_qkv_fused(case, b, l, D, cuda, seed=l + heads)
    got = fa.flash_mha_qkv_packed(qkv, heads)
    torch.cuda.synchronize()
    want = fa.flash_mha_qkv_packed_reference(qkv, heads)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.cuda
def test_qkv_kernel_gradient_matches_twin(cuda):
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn(2, 512, 3 * D, generator=gen).to(cuda)
    do = torch.randn(2, 512, D, generator=gen).to(cuda)
    a = qkv.clone().requires_grad_()
    fa.flash_mha_qkv_packed(a, HEADS).backward(do)
    b = qkv.clone().requires_grad_()
    fa.flash_mha_qkv_packed_reference(b, HEADS).backward(do)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_qkv_kernel_rejects_what_it_cannot_take(cuda):
    qkv = torch.randn(1, 512, 3 * D, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_mha_qkv_packed(qkv.half(), HEADS)
    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed(qkv, 1)                  # head width 128
    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed(qkv[:, :500], HEADS)     # L % 128
