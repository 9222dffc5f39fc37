"""The port's unmasked attention (fudanocr_tpu_torch/ops/region_attention.py
`packed_flash_mha`, ops/flash_attention.py `flash_mha`) against the JAX
package on the CPU, on the same seeded numpy inputs:

* `packed_flash_mha` equals the JAX Pallas kernel run in interpret mode,
  as tests/test_region_attention.py runs it, fp32, atol 1e-5;
* `flash_mha` equals the JAX `flash_mha` at a full-K shape (`_mha_full`)
  and at an online-softmax shape (`_flash_mha_impl`), fp32, atol 1e-5;
* both again in bf16 on the same bf16 operands, atol 2e-2 (about one bf16
  ulp at |o| <= 4): the plain versions, which the card's kernels are held
  against, round where the JAX kernels round;
* the routing gates equal the JAX gates on a grid of shapes under the JAX
  gates' CPU bound (2^24 score entries), where their CPU and device
  conditions coincide.

Tests marked `cuda` hold the hand-written kernels (csrc/
unmasked_attention.cu) against the plain version on the card, the bf16
tensor-core forward and the fp32 split-TF32 forward also at their edge
cases (tests/torch_attention_cases.py), check by torch.profiler which
kernel a call runs, and skip where there is no card. The JAX package is
imported inside the tests that use it, so the `cuda` tests also run where
jax is not installed:

    python -m pytest tests/test_torch_seg_attention.py -m cuda --noconftest
"""

import itertools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.models.seg import cascade_mit as pcm
from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.ops import region_attention as ra
from torch_attention_cases import CASES, FP32_CASES, edge_qkv, heads_view
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5   # fp32, the same math in another summation order
BF16_ATOL = 2e-2   # bf16 outputs: about one bf16 ulp at |o| <= 4


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


def _both(jnp, arrays, dtype):
    """The same operands for both packages: torch tensors of `dtype` and
    the jax arrays of their exact values, in buffers of JAX's own (on the
    CPU `jnp.asarray` may alias a large numpy buffer, which would leave the
    two packages sharing memory while JAX computes asynchronously)."""
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ts, [jnp.asarray(t.float().numpy().copy(), jdt) for t in ts]


def _attention_f64(q, k, v, heads):
    """softmax(q k^T / sqrt(dh)) v in float64 over (B, L, H*dh) operands:
    the yardstick that says which side moved when the two disagree."""
    q, k, v = (t.double().unflatten(-1, (heads, -1)).transpose(1, 2)
               for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    o = torch.softmax(s, -1) @ v
    return o.transpose(1, 2).flatten(2).numpy()


def _cases(rows, ids):
    """fp32 rows under their old ids, then each row again in bf16."""
    return ([pytest.param(*r, torch.float32, id=i) for r, i in zip(rows, ids)]
            + [pytest.param(*r, torch.bfloat16, id="bf16-" + i)
               for r, i in zip(rows, ids)])


def _assert_close(got, want, dtype, exact=None):
    """got (torch) against want (JAX); `exact`, a float64 result, names
    the side that moved in the failure message."""
    atol = BF16_ATOL if dtype == torch.bfloat16 else ATOL
    assert got.dtype == dtype
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    msg = "" if exact is None else (
        f"port vs float64 {np.abs(got - exact).max():.3e}, "
        f"JAX vs float64 {np.abs(want - exact).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


@pytest.mark.parametrize("b,lq,lkv,d,heads,dtype", _cases(
    [(2, 1024, 128, 32, 1), (2, 1024, 256, 64, 2)],
    ["2-1024-128-32-1", "2-1024-256-64-2"]))
def test_packed_flash_mha_matches_jax(jx, b, lq, lkv, d, heads, dtype):
    jnp, jra, _, _ = jx
    rng = np.random.default_rng(lq + lkv + d)
    (q, k, v), jargs = _both(jnp, [_randn(rng, b, lq, d),
                                   _randn(rng, b, lkv, d),
                                   _randn(rng, b, lkv, d)], dtype)
    want = np.asarray(jra.packed_flash_mha(*jargs, heads))
    got = ra.packed_flash_mha(q, k, v, heads)
    assert got.shape == (b, lq, d)
    _assert_close(got, want, dtype, _attention_f64(q, k, v, heads))


@pytest.mark.parametrize("q_shape,lk,dtype", _cases(
    [((1, 2, 512, 32), 512),       # full-K
     ((1, 1, 1024, 32), 2048)],    # online
    ["q_shape0-512", "q_shape1-2048"]))
def test_flash_mha_matches_jax(jx, q_shape, lk, dtype):
    jnp, _, jfa, _ = jx
    rng = np.random.default_rng(lk)
    b, h, _, dh = q_shape
    (q, k, v), jargs = _both(jnp, [_randn(rng, *q_shape),
                                   _randn(rng, b, h, lk, dh),
                                   _randn(rng, b, h, lk, dh)], dtype)
    _assert_close(fa.flash_mha(q, k, v), jfa.flash_mha(*jargs), dtype)


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


# the bf16 tensor-core forward at its edge cases, packed (B7) and head-major
# (B5): (B, Lq, Lkv, D, heads, case)
MMA_CASES = [(2, 128, 64, 32, 1, "plain"),      # one q block, one key tile
             (2, 1024, 1024, 512, 8, "plain"),  # dh 64, 8 heads
             *((2, 512, 256, 64, 2, c) for c in CASES if c != "plain")]


def _check_rising(q, k, heads):
    """Most rows' max lies in the last key tile (the case's premise)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float().unflatten(-1, (heads, -1)),
                     k.float().unflatten(-1, (heads, -1)))
    last = s.argmax(-1) >= k.shape[1] - fa.UNMASKED_KEY_TILE
    assert last.float().mean() > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lkv,d,heads,case", MMA_CASES)
def test_bf16_packed_kernel_edge_cases(cuda, b, lq, lkv, d, heads, case):
    q, k, v = edge_qkv(case, b, lq, lkv, d, cuda, seed=lq + d)
    if case == "rising":
        _check_rising(q, k, heads)
    got = ra.packed_flash_mha(q, k, v, heads)
    torch.cuda.synchronize()
    want = ra.packed_flash_mha_reference(q, k, v, heads)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lkv,d,heads,case", MMA_CASES)
def test_bf16_head_major_kernel_edge_cases(cuda, b, lq, lkv, d, heads,
                                           case):
    """B5 on strided (B, H, L, dh) views of packed buffers."""
    q, k, v = (heads_view(t, heads)
               for t in edge_qkv(case, b, lq, lkv, d, cuda, seed=lq + d))
    got = fa.flash_mha(q, k, v)
    torch.cuda.synchronize()
    assert got.stride() == q.stride() or case == "odd"
    want = fa.flash_mha_reference(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


def _attn_fwd_kernels(fn) -> list:
    """Names of the attention forward kernels that calls of `fn` launch,
    from a torch.profiler trace of ten calls after a warm-up call; a
    trace that holds no device event at all is taken again (at most
    twice), as chip_smoke.py's `attn_kernel_name` does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        events = [e.key for e in prof.key_averages()
                  if e.device_time_total > 0]
        if events:
            break
    return [k for k in events if "attn_fwd" in k]


@pytest.mark.cuda
def test_only_bf16_unmasked_inference_runs_the_tensor_core_kernel(cuda):
    """Which forward each call runs: every bf16 call the bf16 tensor-core
    kernel (unmasked inference, MASKED, STATS, in their template
    variants), every fp32 call the split-TF32 one (also on the tensor
    cores)."""
    q, k, v = edge_qkv("plain", 1, 256, 128, 64, cuda)
    odd = edge_qkv("odd", 1, 256, 128, 64, cuda)
    f32 = [t.float() for t in (q, k, v)]
    rq = torch.zeros(1, 256, device=cuda)
    rkv = torch.arange(128, device=cuda, dtype=torch.float32)[None] % 2
    trained = [t.clone().requires_grad_() for t in (q, k, v)]
    runs = {
        "packed bf16": (lambda: ra.packed_flash_mha(q, k, v, 2),
                        "attn_fwd_mma_kernel<32, true, false, false>"),
        "packed bf16, odd offsets": (lambda: ra.packed_flash_mha(*odd, 2),
                                     "attn_fwd_mma_kernel<32, false, false, "
                                     "false>"),
        "head-major bf16": (lambda: fa.flash_mha(
            *(heads_view(t, 2) for t in (q, k, v))),
            "attn_fwd_mma_kernel<32, true, false, false>"),
        "packed fp32": (lambda: ra.packed_flash_mha(*f32, 2),
                        "attn_fwd_tf32x3_kernel<32, false, false>"),
        "head-major fp32": (lambda: fa.flash_mha(
            *(heads_view(t, 2) for t in f32)),
            "attn_fwd_tf32x3_kernel<32, false, false>"),
        "region fp32": (lambda: ra.region_flash_mha(*f32, rq, rkv, 2),
                        "attn_fwd_tf32x3_kernel<32, true, false>"),
        "training forward fp32": (lambda: ra.packed_flash_mha(
            *(t.clone().requires_grad_() for t in f32), 2),
            "attn_fwd_tf32x3_kernel<32, false, true>"),
        "region bf16": (lambda: ra.region_flash_mha(q, k, v, rq, rkv, 2),
                        "attn_fwd_mma_kernel<32, true, true, false>"),
        "training forward bf16": (lambda: ra.packed_flash_mha(*trained, 2),
                                  "attn_fwd_mma_kernel<32, true, false, "
                                  "true>"),
        "region training forward bf16": (lambda: ra.region_flash_mha(
            *(t.clone().requires_grad_() for t in (q, k, v)), rq, rkv, 2),
            "attn_fwd_mma_kernel<32, true, true, true>"),
    }
    for what, (fn, want) in runs.items():
        names = _attn_fwd_kernels(fn)
        assert len(names) == 1 and want in names[0], (what, names)


# the fp32 split-TF32 forward at its edge cases, packed (B7, B6) and
# head-major (B5), against the plain version at the fp32 bar:
# (B, Lq, Lkv, D, heads, case)
FP32_EDGE = [(2, 128, 64, 32, 1, "plain"),      # one q block, one key tile
             (2, 1024, 1024, 512, 8, "plain"),  # dh 64, 8 heads
             *((2, 512, 256, 64, 2, c) for c in FP32_CASES if c != "plain"),
             (2, 512, 256, 128, 2, "peaked"),   # dh 64
             (2, 512, 256, 128, 2, "large")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lkv,d,heads,case", FP32_EDGE)
def test_fp32_packed_kernel_edge_cases(cuda, b, lq, lkv, d, heads, case):
    q, k, v = edge_qkv(case, b, lq, lkv, d, cuda, seed=lq + d,
                       dtype=torch.float32)
    if case == "rising":
        _check_rising(q, k, heads)
    got = ra.packed_flash_mha(q, k, v, heads)
    torch.cuda.synchronize()
    want = ra.packed_flash_mha_reference(q, k, v, heads)
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lkv,d,heads,case", FP32_EDGE)
def test_fp32_head_major_kernel_edge_cases(cuda, b, lq, lkv, d, heads,
                                           case):
    q, k, v = (heads_view(t, heads) for t in edge_qkv(
        case, b, lq, lkv, d, cuda, seed=lq + d, dtype=torch.float32))
    got = fa.flash_mha(q, k, v)
    torch.cuda.synchronize()
    want = fa.flash_mha_reference(q, k, v)
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lkv,d,heads,case", FP32_EDGE)
def test_fp32_region_kernel_edge_cases(cuda, b, lq, lkv, d, heads, case):
    """B6 with ids that suppress every pair of the second image's first
    half of q rows (their output is the mean of v) and some pairs
    elsewhere."""
    q, k, v = edge_qkv(case, b, lq, lkv, d, cuda, seed=lq + d,
                       dtype=torch.float32)
    gen = torch.Generator().manual_seed(lq)
    rq = torch.randint(0, 3, (b, lq), generator=gen).float()
    rkv = torch.randint(0, 3, (b, lkv), generator=gen).float()
    rkv[1], rq[1, :lq // 2] = 1.0, 1.0
    rq, rkv = rq.to(cuda), rkv.to(cuda)
    got = ra.region_flash_mha(q, k, v, rq, rkv, heads)
    torch.cuda.synchronize()
    want = ra.region_flash_mha_reference(q, k, v, rq, rkv, heads)
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    mean_v = v[1].mean(0).expand(lq // 2, -1)
    torch.testing.assert_close(got[1, :lq // 2], mean_v,
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
