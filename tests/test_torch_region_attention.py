"""The port's region-masked attention (fudanocr_tpu_torch/ops/
region_attention.py `region_flash_mha`, kernel B6) against the JAX package
on the CPU, on the same seeded numpy inputs:

* `region_flash_mha_reference` equals the JAX `region_flash_mha` run as
  tests/test_region_attention.py runs it (Pallas interpret mode on the
  CPU), fp32, atol 1e-5 (the same math in another summation order), with
  ids that include fully suppressed rows (equal to the mean of v), rows
  with no suppressed pair, and 0.5 ids;
* the region gate equals the JAX gate below the JAX gate's CPU bound;
* on CPU tensors the wrapper is the plain version and launches nothing.

Tests marked `cuda` hold the MASKED kernel of csrc/unmasked_attention.cu
against the plain version on the card and skip where there is none:

    python -m pytest tests/test_torch_region_attention.py -m cuda --noconftest
"""

import itertools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.ops import region_attention as ra

ATOL = 1e-5


def _ids(rng, b, lq, lkv):
    """Image 0: ids from {0, 0.5, 1} on both sides and 3 on some q rows
    (never on a key: nothing suppressed there); image 1: every key has id
    1, so its q rows with id 1 are fully suppressed and the others (0.5)
    suppress nothing."""
    rq = rng.choice(np.float32([0, 0.5, 1, 3]), (b, lq))
    rkv = rng.choice(np.float32([0, 0.5, 1]), (b, lkv))
    rkv[1] = 1.0
    rq[1] = np.where(rng.random(lq) < 0.5, 1.0, 0.5)
    return rq.astype(np.float32), rkv.astype(np.float32)


def _inputs(seed, b, lq, lkv, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, lq, d), (b, lkv, d), (b, lkv, d)))
    return q, k, v, *_ids(rng, b, lq, lkv)


def test_region_flash_mha_matches_jax():
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import region_attention as jra

    heads = 2
    q, k, v, rq, rkv = _inputs(0, 2, 1024, 128, 64)
    assert jra.region_flash_supported(1024, 128, 64, heads)  # the kernel
    want = np.asarray(jra.region_flash_mha(*map(jax.numpy.asarray,
                                                (q, k, v, rq, rkv)), heads))
    args = [torch.from_numpy(a) for a in (q, k, v, rq, rkv)]
    got = ra.region_flash_mha_reference(*args, heads).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # fully suppressed rows are uniform: the mean of v, in both packages
    full = rq[1] == 1.0
    mean_v = v[1].mean(0)
    for out in (got, want):
        np.testing.assert_allclose(out[1][full],
                                   np.broadcast_to(mean_v, out[1][full].shape),
                                   rtol=0, atol=ATOL)
    # and the rows that suppress nothing are the unmasked attention
    free = ~full
    plain = ra.packed_flash_mha_reference(*args[:3], heads).numpy()
    np.testing.assert_allclose(got[1][free], plain[1][free], rtol=0,
                               atol=ATOL)
    assert not np.allclose(got[0], plain[0], atol=1e-3)   # image 0 masked


def test_region_gate_matches_jax():
    pytest.importorskip("jax")
    from fudanocr_tpu.ops import region_attention as jra

    n = 0
    for lq, lkv, (d, heads) in itertools.product(
            (256, 768, 1024, 2048, 4096, 8192, 16384),
            (64, 128, 256, 384, 1024, 2048, 4096),
            [(32, 1), (64, 2), (160, 5), (256, 8), (640, 8), (40, 5)]):
        if lq * lkv > 2 ** 24:
            continue
        assert ra.region_flash_supported(lq, lkv, d, heads) == \
            jra.region_flash_supported(lq, lkv, d, heads), (lq, lkv, d, heads)
        n += 1
    assert n > 150


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_region_wrapper_on_cpu_is_the_plain_version(dtype):
    q, k, v, rq, rkv = (torch.from_numpy(a) for a in
                        _inputs(1, 2, 256, 128, 64))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    n0 = ra.region_packed_fwd.launches
    got = ra.region_flash_mha(q, k, v, rq, rkv, 2)
    assert torch.equal(got, ra.region_flash_mha_reference(q, k, v, rq, rkv,
                                                          2))
    assert got.dtype == dtype and got.shape == (2, 256, 64)
    assert ra.region_packed_fwd.launches == n0
    with pytest.raises(ValueError):
        ra.region_flash_mha(q.to("meta"), k.to("meta"), v.to("meta"),
                            rq.to("meta"), rkv.to("meta"), 2)


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
                                              (2, 1024, 512, 128, 2),
                                              (1, 2048, 1024, 256, 8)])
def test_region_kernel_matches_plain_version(cuda, dtype, b, lq, lkv, d,
                                             heads):
    q, k, v, rq, rkv = (torch.from_numpy(a).to(cuda) for a in
                        _inputs(lq + d, max(b, 2), lq, lkv, d))
    q = q[:b].to(dtype)
    kv = torch.cat([k, v], -1)[:b].to(dtype)
    k, v = kv[..., :d], kv[..., d:]          # row stride 2D, read in place
    rq, rkv = rq[:b].contiguous(), rkv[:b].contiguous()
    n0 = ra.region_packed_fwd.launches
    got = ra.region_flash_mha(q, k, v, rq, rkv, heads)
    torch.cuda.synchronize()
    assert ra.region_packed_fwd.launches == n0 + 1
    want = ra.region_flash_mha_reference(q, k, v, rq, rkv, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if b > 1:   # image 1's rows with id 1 are fully suppressed
        full = rq[1] == 1.0
        mean_v = v[1].float().mean(0).expand(int(full.sum()), d)
        torch.testing.assert_close(got[1][full].float(), mean_v,
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_region_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.randn(2, 1024, 256, device=cuda)
    k = torch.randn(2, 256, 256, device=cuda)
    rq = torch.zeros(2, 1024, device=cuda)
    rkv = torch.zeros(2, 256, device=cuda)
    with pytest.raises(TypeError):
        ra.region_flash_mha(q.half(), k.half(), k.half(), rq, rkv, 8)
    with pytest.raises(ValueError):
        ra.region_flash_mha(q, k, k, rq, rkv, 16)                # width 16
    with pytest.raises(ValueError):
        ra.region_flash_mha(q[:, :1000], k, k, rq[:, :1000], rkv, 8)
    with pytest.raises(ValueError):
        ra.region_flash_mha(q, k, k, rq.double(), rkv, 8)        # id dtype
    with pytest.raises(ValueError):
        ra.region_flash_mha(q, k, k, torch.zeros(1024, 2, device=cuda).t(),
                            rkv, 8)                              # strided ids
    with pytest.raises(ValueError):
        ra.region_flash_mha(q, k, k, rq[:1], rkv, 8)             # id shape
    with pytest.raises(ValueError):
        ra.region_flash_mha(q, k, k, rq.cpu(), rkv, 8)           # id device
    with pytest.raises(ValueError):     # backward: Lkv not a multiple of 128
        ra.region_flash_mha(q.requires_grad_(), k[:, :192], k[:, :192], rq,
                            rkv[:, :192], 8)
