"""The rounding points of the bf16 training and region-masked attention
kernels of fudanocr_tpu_torch/csrc/unmasked_attention.cu
(`attn_fwd_mma_kernel` with MASKED and STATS, `attn_bwd_dq_mma_kernel`,
`attn_bwd_dkv_mma_kernel`) on the CPU, before any card runs them.

`bf16_attention_model` (tests/torch_attention_cases.py) is their arithmetic
in plain torch: bf16(p) for the forward's value product, as JAX rounds it;
fp32 o32 for the backward's D = dO . o32 from p as a bf16 pair; in the
backward P and dS rounded to bf16 for dV and dK, and dS as a bf16 pair for
dQ. It is held against the JAX package's Pallas kernels run in interpret
mode on bf16 inputs (region_attention.py `_plain_fwd`/`_plain_bwd`
through `packed_flash_mha`, `_region_fwd`/`_region_bwd` through
`region_flash_mha`), at q (2, 1024, D), k/v (2, 256, D), one head of 32
or two of 64, on standard normals and the peaked cases of
tests/torch_attention_cases.py ("rising": every row's max in the last key
tile; "x16": scores up to ~60), unmasked and region-masked (image 0 mixed
ids, image 1 with fully suppressed rows, which come out as the mean of v).

Bars, the card's bf16 ones (chip_smoke.py ATTN_ATOL, GRAD_REL): 2e-2
absolute forward, 1e-2 norm-relative gradients. The model's dq, dk and dv
each stay within half the gradient bar, its forward output within half the
forward bar or, where that is less, one bf16 ulp of JAX's: both round o to
bf16, so where |o| >= 2 one ulp (1.6e-2) is the least distance a
differently ordered sum can show. Two rejected
simplifications each take dq past half the bar on the "rising" case: o32
from bf16(p) (D then misses JAX's fp32 rowsum(dP P)) and dS rounded once
for dQ (a row of dS sums to 0; one rounding lets K's mean into dQ).

The port's plain versions (the CPU path and `kernels=False`) are held to
JAX's kernels on the same inputs: the forward at the bar, the plain
backward within PLAIN_REL. The CPU path's autograd backward is the plain
backward, bit for bit, in bf16 and in fp32 (against JAX's fp32 kernels on
"rising"): autograd through the plain forward would take bf16(p) into D
and miss the bar on "rising".

Tests marked `cuda` hold the kernels against the model and the plain
version on the card and skip where there is none; they import no jax:

    python -m pytest tests/test_torch_seg_bf16_rounding.py -m cuda --noconftest
"""

import functools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.ops import region_attention as ra
from torch_attention_cases import (CASES, _values, bf16_attention_model,
                                   edge_qkv)
from torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
FWD_ATOL, BWD_REL = 2e-2, 1e-2   # chip_smoke.py ATTN_ATOL, GRAD_REL (bf16)
# the plain versions compute JAX's backward in fp32 as JAX does: their
# distance is summation order and the outputs' rounding (measured <= 1e-4)
PLAIN_REL = 1e-3
B, LQ, LKV = 2, 1024, 256   # Lq >= 1024, Lq * Lkv <= 2^24: JAX's CPU gate
JAX_CASES = ("plain", "rising", "x16")
WIDTHS = ((32, 1), (64, 2))   # (dh, heads)


def _ids(seed: int, b: int = B, lq: int = LQ, lkv: int = LKV):
    """fp32 ids as tests/test_torch_seg_attention_bwd.py makes them: image
    0 mixes {0, 0.5, 1} (and 3 on q rows, which suppresses nothing); image
    1 gives every key id 1, so its q rows with id 1 are fully suppressed."""
    rng = np.random.default_rng(seed)
    rq = rng.choice(np.float32([0, 0.5, 1, 3]), (b, lq)).astype(np.float32)
    rkv = rng.choice(np.float32([0, 0.5, 1]), (b, lkv)).astype(np.float32)
    rkv[1] = 1.0
    rq[1] = np.where(rng.random(lq) < 0.5, 1.0, 0.5)
    return torch.from_numpy(rq), torch.from_numpy(rkv)


def _inputs(case: str, dh: int, heads: int, dtype=BF16):
    d = dh * heads
    q, k, v = (t.to(dtype) for t in _values(case, B, LQ, LKV, d,
                                             dh + len(case)))
    do = torch.randn(B, LQ, d, generator=torch.Generator().manual_seed(
        dh + 1)).to(dtype)
    return q, k, v, do, *_ids(dh)


@functools.lru_cache(maxsize=None)
def _jax(case: str, dh: int, heads: int, masked: bool, dtype=BF16):
    """The inputs and the JAX kernels' o and (dq, dk, dv) on them
    (interpret mode, bf16 unless `dtype` is float32), as float32 torch
    tensors."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import region_attention as jra

    jnp = jax.numpy
    q, k, v, do, rq, rkv = _inputs(case, dh, heads, dtype)
    assert jra.region_flash_supported(LQ, LKV, dh * heads, heads)
    if masked:
        fn = lambda q_, k_, v_: jra.region_flash_mha(
            q_, k_, v_, jnp.asarray(rq.numpy()), jnp.asarray(rkv.numpy()),
            heads)
    else:
        fn = lambda q_, k_, v_: jra.packed_flash_mha(q_, k_, v_, heads)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jdt)
    o, vjp = jax.vjp(fn, *map(as_jax, (q, k, v)))
    grads = vjp(as_jax(do))
    as_torch = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
    return ((q, k, v, do, rq, rkv), as_torch(o),
            [as_torch(g) for g in grads])


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _fwd_ratio(got, want) -> float:
    """The largest |got - want| over half the forward bar or, where it is
    larger, one bf16 ulp of want (|want| >= 2)."""
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8)
    bar = torch.clamp(ulp, min=FWD_ATOL / 2)
    return ((got.float() - want.float()).abs() / bar).max().item()


def _full_rows(rq, rkv):
    return (rq[:, :, None] == rkv[:, None, :]).all(-1)


def _model(case, dh, heads, masked, **kw):
    ins, want_o, want_g = _jax(case, dh, heads, masked)
    q, k, v, do, rq, rkv = ins
    ids = (rq, rkv) if masked else (None, None)
    o, o32, _, _, *grads = bf16_attention_model(q, k, v, heads, *ids, do=do,
                                                **kw)
    return ins, (o, o32, want_o), list(zip(grads, want_g))


PARAMS = [pytest.param(c, dh, h, m,
                       id=f"{c}-dh{dh}-{'masked' if m else 'plain'}")
          for c in JAX_CASES for dh, h in WIDTHS for m in (False, True)]


@pytest.mark.parametrize("case,dh,heads,masked", PARAMS)
def test_model_matches_jax(case, dh, heads, masked):
    ins, (o, o32, want_o), grads = _model(case, dh, heads, masked)
    print(f"{case} dh {dh} {'masked' if masked else 'unmasked'}: model o "
          f"{_fwd_ratio(o, want_o):.3f} of the forward bar, dq/dk/dv rel "
          f"{[round(_rel(g, w), 5) for g, w in grads]}")
    assert _fwd_ratio(o, want_o) <= 1.0
    # o32, the fp32 probabilities' product, beside bf16(p)'s
    assert _fwd_ratio(o32, o.float()) <= 1.0
    for name, (g, w) in zip(("dq", "dk", "dv"), grads):
        assert _rel(g, w) <= BWD_REL / 2, (name, _rel(g, w))
    if masked:   # fully suppressed rows: the mean of v, their dq on its own
        q, k, v, do, rq, rkv = ins
        full = _full_rows(rq, rkv)
        assert full.sum() > 0 and (~full).sum() > 0
        mean_v = v.float().mean(1, keepdim=True).expand(-1, LQ, -1)[full]
        assert _fwd_ratio(o[full], mean_v) <= 1.0
        dq, want_dq = grads[0]
        assert _rel(dq[full], want_dq[full]) <= BWD_REL / 2


@pytest.mark.parametrize("rejected", [dict(o32_from="hi"),
                                      dict(dq_split=False)],
                         ids=["o32-from-bf16-p", "dS-rounded-once-for-dq"])
@pytest.mark.parametrize("dh,heads", WIDTHS)
@pytest.mark.parametrize("masked", [False, True])
def test_rejected_simplification_misses_half_the_bar(rejected, dh, heads,
                                                     masked):
    """Each rejected simplification takes dq past half the bar where every
    row's max lies in the last key tile; the chosen pairs keep it 20x
    under."""
    _, _, grads = _model("rising", dh, heads, masked, **rejected)
    _, _, chosen = _model("rising", dh, heads, masked)
    print(f"rising dh {dh} {'masked' if masked else 'unmasked'} {rejected}:"
          f" dq rel {_rel(*grads[0]):.5f}, chosen {_rel(*chosen[0]):.5f}")
    assert _rel(*grads[0]) > BWD_REL / 2
    assert _rel(*chosen[0]) < BWD_REL / 20


@pytest.mark.parametrize("case,dh,heads,masked", PARAMS)
def test_plain_version_matches_jax(case, dh, heads, masked):
    """The port's plain forward at the bar and its plain backward within
    PLAIN_REL, each gradient. The CPU path's autograd backward is the plain
    backward bit for bit, so within the bar of JAX's on every case: autograd
    through the plain forward would take bf16(p) into D, the rejected
    o32-from-bf16(p), and on "rising" its dq missed the bar."""
    ins, want_o, want_g = _jax(case, dh, heads, masked)
    q, k, v, do, rq, rkv = ins
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if masked:
        o = ra.region_flash_mha(*leaves, rq, rkv, heads)
        plain = ra.region_flash_mha_bwd_reference(q, k, v, rq, rkv, do,
                                                  heads)
    else:
        o = ra.packed_flash_mha(*leaves, heads)
        plain = ra.packed_flash_mha_bwd_reference(q, k, v, do, heads)
    auto = torch.autograd.grad(o, leaves, do)
    rels = lambda gs: [round(_rel(g, w), 5) for g, w in zip(gs, want_g)]
    print(f"{case} dh {dh} {'masked' if masked else 'unmasked'}: plain "
          f"backward dq/dk/dv rel {rels(plain)}, autograd through the "
          f"plain forward {rels(auto)}")
    assert o.dtype == BF16
    assert (o.float() - want_o).abs().max().item() <= FWD_ATOL
    for name, g, a, w in zip(("dq", "dk", "dv"), plain, auto, want_g):
        assert g.dtype == a.dtype == BF16
        assert _rel(g, w) <= PLAIN_REL, name
        assert torch.equal(a, g), name
        assert _rel(a, w) <= BWD_REL, (name, _rel(a, w))


@pytest.mark.parametrize("dh,heads", WIDTHS)
@pytest.mark.parametrize("masked", [False, True])
def test_fp32_cpu_backward_matches_jax(dh, heads, masked):
    """In fp32 the CPU path's autograd backward is the plain backward bit
    for bit, and within PLAIN_REL of JAX's fp32 kernels on "rising"."""
    ins, want_o, want_g = _jax("rising", dh, heads, masked, torch.float32)
    q, k, v, do, rq, rkv = ins
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if masked:
        o = ra.region_flash_mha(*leaves, rq, rkv, heads)
        plain = ra.region_flash_mha_bwd_reference(q, k, v, rq, rkv, do,
                                                  heads)
    else:
        o = ra.packed_flash_mha(*leaves, heads)
        plain = ra.packed_flash_mha_bwd_reference(q, k, v, do, heads)
    auto = torch.autograd.grad(o, leaves, do)
    assert o.dtype == torch.float32
    assert (o - want_o).abs().max().item() <= 1e-5
    for name, a, g, w in zip(("dq", "dk", "dv"), auto, plain, want_g):
        assert torch.equal(a, g), name
        assert _rel(a, w) <= PLAIN_REL, (name, _rel(a, w))


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the kernels against the model on the same inputs: the same rounding
# points, sums in another order (a bf16 rounding of P or dS flips now and
# then)
MODEL_REL = 2e-3


def _card_inputs(case, b, lq, lkv, d, device, seed):
    q, k, v = edge_qkv(case, b, lq, lkv, d, device, seed=seed)
    do = torch.randn(b, lq, d, generator=torch.Generator().manual_seed(
        seed + 1)).to(device, BF16)
    rq, rkv = (t.to(device) for t in _ids(seed, b, lq, lkv))
    return q, k, v, do, rq, rkv


# (B, Lq, Lkv, D, heads): one q block over one key tile (forward only) or
# one key block, a longer run of tiles, dh 64, and five heads of 32
FWD_SHAPES = [(2, 128, 64, 32, 1), (2, 1024, 512, 128, 4),
              (2, 1024, 256, 128, 2), (2, 1024, 256, 160, 5)]
BWD_SHAPES = [(2, 1024, 128, 32, 1), (2, 1024, 512, 128, 4),
              (2, 1024, 256, 128, 2), (2, 1024, 256, 160, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,lq,lkv,d,heads", FWD_SHAPES)
def test_bf16_forward_kernels_match_model(cuda, b, lq, lkv, d, heads, case,
                                          masked):
    """The MASKED inference forward and the STATS forward (o, o32 and the
    statistics) against the model and the plain version; fully suppressed
    rows are the mean of v."""
    q, k, v, _, rq, rkv = _card_inputs(case, b, lq, lkv, d, cuda, lq + d)
    ids = (rq, rkv) if masked else (None, None)
    n0 = (ra.unmasked_packed_fwd.launches, ra.region_packed_fwd.launches)
    if masked:
        inf = ra.region_packed_fwd(q, k, v, rq, rkv, heads)
        o, o32, m, inv = ra.region_packed_fwd(q, k, v, rq, rkv, heads,
                                              stats=True)
        plain = ra.region_flash_mha_reference(q, k, v, rq, rkv, heads)
    else:
        inf = ra.unmasked_packed_fwd(q, k, v, heads)
        o, o32, m, inv = ra.unmasked_packed_fwd(q, k, v, heads, stats=True)
        plain = ra.packed_flash_mha_reference(q, k, v, heads)
    torch.cuda.synchronize()
    n1 = (ra.unmasked_packed_fwd.launches, ra.region_packed_fwd.launches)
    assert n1 == ((n0[0], n0[1] + 2) if masked else (n0[0] + 2, n0[1]))
    want = bf16_attention_model(q, k, v, heads, *ids)
    assert o.dtype == inf.dtype == BF16 and o32.dtype == torch.float32
    for got in (inf, o):
        assert (got.float() - plain.float()).abs().max().item() <= FWD_ATOL
        assert _fwd_ratio(got, want[0]) <= 1.0
    assert torch.equal(o, inf)
    torch.testing.assert_close(o32, want[1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(m, want[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv, want[3], rtol=1e-4, atol=0)
    if masked:
        full = _full_rows(rq, rkv)
        mean_v = v.float().mean(1, keepdim=True).expand(-1, lq, -1)[full]
        assert full.any()
        assert _fwd_ratio(o[full], mean_v.to(BF16)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,lq,lkv,d,heads", BWD_SHAPES)
def test_bf16_backward_kernels_match_model(cuda, b, lq, lkv, d, heads, case,
                                           masked):
    """The tensor-core backward through autograd against the model
    (MODEL_REL) and the plain backward (the card's bar), each gradient;
    the fully suppressed rows' dq on its own."""
    q, k, v, do, rq, rkv = _card_inputs(case, b, lq, lkv, d, cuda, lq + d)
    ids = (rq, rkv) if masked else (None, None)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    n0 = (ra.unmasked_packed_bwd.launches, ra.region_packed_bwd.launches)
    o = (ra.region_flash_mha(*leaves, rq, rkv, heads) if masked
         else ra.packed_flash_mha(*leaves, heads))
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    n1 = (ra.unmasked_packed_bwd.launches, ra.region_packed_bwd.launches)
    assert n1 == ((n0[0], n0[1] + 1) if masked else (n0[0] + 1, n0[1]))
    model = bf16_attention_model(q, k, v, heads, *ids, do=do)[4:]
    plain = (ra.region_flash_mha_bwd_reference(q, k, v, rq, rkv, do, heads)
             if masked else ra.packed_flash_mha_bwd_reference(q, k, v, do,
                                                              heads))
    for name, g, mo, p in zip(("dq", "dk", "dv"), got, model, plain):
        assert g.dtype == BF16 and torch.isfinite(g).all()
        assert _rel(g, mo) <= MODEL_REL, (name, _rel(g, mo))
        assert _rel(g, p) <= BWD_REL, (name, _rel(g, p))
    if masked:
        full = _full_rows(rq, rkv)
        assert full.any() and _rel(got[0][full], plain[0][full]) <= BWD_REL
