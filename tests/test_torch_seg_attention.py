"""The port's unmasked attention (fudanocr_tpu_torch/ops/region_attention.py
`packed_flash_mha`, ops/flash_attention.py `flash_mha`) against the JAX
package on the CPU, on the same seeded numpy inputs:

* `packed_flash_mha` equals the JAX Pallas kernel run in interpret mode,
  as tests/test_region_attention.py runs it, fp32, atol 1e-5;
* `flash_mha` equals the JAX `flash_mha` at a full-K shape (`_mha_full`)
  and at an online-softmax shape (`_flash_mha_impl`), fp32, atol 1e-5;
* the routing gates equal the JAX gates on a grid of shapes under the JAX
  gates' CPU bound (2^24 score entries), where their CPU and device
  conditions coincide.

Tests marked `cuda` hold the hand-written kernel (csrc/
unmasked_attention.cu) against the plain version on the card and skip
where there is none. The JAX package is imported inside the tests that use
it, so the `cuda` tests also run where jax is not installed:

    python -m pytest tests/test_torch_seg_attention.py -m cuda --noconftest
"""

import itertools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.models.seg import cascade_mit as pcm
from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.ops import region_attention as ra

ATOL = 1e-5   # fp32, the same math in another summation order


@pytest.fixture
def jx():
    """(jax.numpy, the JAX region_attention, flash_attention and
    cascade_mit modules)."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.models.seg import cascade_mit as jcm
    from fudanocr_tpu.ops import flash_attention as jfa
    from fudanocr_tpu.ops import region_attention as jra

    return jax.numpy, jra, jfa, jcm


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,lq,lkv,d,heads", [(2, 1024, 128, 32, 1),
                                              (2, 1024, 256, 64, 2)])
def test_packed_flash_mha_matches_jax(jx, b, lq, lkv, d, heads):
    jnp, jra, _, _ = jx
    rng = np.random.default_rng(lq + lkv + d)
    q, k, v = _randn(rng, b, lq, d), _randn(rng, b, lkv, d), \
        _randn(rng, b, lkv, d)
    want = np.asarray(jra.packed_flash_mha(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), heads))
    got = ra.packed_flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), heads)
    assert got.shape == (b, lq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("q_shape,lk", [((1, 2, 512, 32), 512),     # full-K
                                        ((1, 1, 1024, 32), 2048)])  # online
def test_flash_mha_matches_jax(jx, q_shape, lk):
    jnp, _, jfa, _ = jx
    rng = np.random.default_rng(lk)
    b, h, _, dh = q_shape
    q, k, v = _randn(rng, *q_shape), _randn(rng, b, h, lk, dh), \
        _randn(rng, b, h, lk, dh)
    want = np.asarray(jfa.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v)))
    got = fa.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_plain_versions_take_strided_views():
    """The plain versions read column slices of a fused projection and
    (B, H, L, dh) views of a (B, L, H*dh) buffer as the kernel does."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 256, 3 * 64, generator=gen)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    want = ra.packed_flash_mha(q.contiguous(), k.contiguous(),
                               v.contiguous(), 2)
    torch.testing.assert_close(ra.packed_flash_mha(q, k, v, 2), want,
                               rtol=0, atol=0)
    heads = lambda t: t.unflatten(-1, (2, 32)).transpose(1, 2)
    o = fa.flash_mha(heads(q), heads(k), heads(v))
    torch.testing.assert_close(o.transpose(1, 2).reshape(2, 256, 64), want,
                               rtol=0, atol=0)


_LQ = (256, 512, 768, 1024, 2048, 3072, 4096, 8192, 16384)
_LKV = (64, 128, 256, 384, 1024, 2048, 4096)


def test_packed_gate_matches_jax(jx):
    _, jra, _, _ = jx
    n = 0
    for lq, lkv, (d, heads) in itertools.product(
            _LQ, _LKV, [(32, 1), (64, 2), (160, 5), (256, 8), (512, 8),
                        (640, 8), (48, 3), (40, 5)]):
        if lq * lkv > 2 ** 24:
            continue
        assert ra.packed_flash_supported(lq, lkv, d, heads) == \
            jra.packed_flash_supported(lq, lkv, d, heads), (lq, lkv, d, heads)
        n += 1
    assert n > 200


def test_flash_gate_matches_jax(jx):
    _, _, _, jcm = jx
    n = 0
    for lq, lk, hd in itertools.product(_LQ, _LKV, (8, 12, 32, 64, 128, 256)):
        if lq * lk > 2 ** 24:
            continue
        shape = (3, 2, lq, hd)
        assert pcm._flash_ok(shape, lk) == \
            jcm._flash_ok(shape, lk), (lq, lk, hd)
        n += 1
    assert n > 200


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lkv,d,heads", [(3, 4096, 1024, 32, 1),
                                              (2, 1024, 1024, 256, 8),
                                              (1, 2048, 512, 512, 8)])
def test_packed_kernel_matches_plain_version(cuda, dtype, b, lq, lkv, d,
                                             heads):
    gen = torch.Generator().manual_seed(lq + d)
    q = torch.randn(b, lq, d, generator=gen).to(cuda, dtype)
    kv = torch.randn(b, lkv, 2 * d, generator=gen).to(cuda, dtype)
    k, v = kv[..., :d], kv[..., d:]          # row stride 2D, read in place
    n0 = ra.unmasked_packed_fwd.launches
    got = ra.packed_flash_mha(q, k, v, heads)
    torch.cuda.synchronize()
    assert ra.unmasked_packed_fwd.launches == n0 + 1
    want = ra.packed_flash_mha_reference(q, k, v, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_shape,lk", [((1, 8, 512, 32), 512),
                                        ((2, 2, 1024, 64), 2048),
                                        ((1, 1, 8192, 32), 4096)])
def test_bhld_kernel_matches_plain_version(cuda, dtype, q_shape, lk):
    gen = torch.Generator().manual_seed(lk)
    b, h, lq, dh = q_shape
    q = torch.randn(b, lq, h * dh, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(b, h, lk, dh, generator=gen).to(cuda, dtype)
            for _ in range(2))
    qh = q.unflatten(-1, (h, dh)).transpose(1, 2)   # strided (B, H, L, dh)
    n0 = fa.unmasked_bhld_fwd.launches
    got = fa.flash_mha(qh, k, v)
    torch.cuda.synchronize()
    assert fa.unmasked_bhld_fwd.launches == n0 + 1
    assert got.stride() == qh.stride()       # q's stride order kept
    want = fa.flash_mha_reference(qh, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_cannot_take(cuda):
    q = torch.randn(1, 1024, 256, device=cuda)
    k = torch.randn(1, 256, 256, device=cuda)
    with pytest.raises(TypeError):
        ra.packed_flash_mha(q.half(), k.half(), k.half(), 8)
    with pytest.raises(ValueError):
        ra.packed_flash_mha(q, k, k, 16)                     # head width 16
    with pytest.raises(ValueError):
        ra.packed_flash_mha(q[:, :1000], k, k, 8)            # Lq % 128
    with pytest.raises(ValueError):
        ra.packed_flash_mha(q, k[:, :200], k[:, :200], 8)    # Lkv % 64
    with pytest.raises(ValueError):
        ra.packed_flash_mha(q.transpose(1, 2), k, k, 8)      # feature stride
    with pytest.raises(ValueError):     # backward: Lkv not a multiple of 128
        ra.packed_flash_mha(q.requires_grad_(), k[:, :192], k[:, :192], 8)
    qh = torch.randn(1, 2, 512, 128, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_mha(qh, qh, qh)                             # head width 128
