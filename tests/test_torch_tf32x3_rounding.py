"""The rounding points of the fp32 attention kernels (fudanocr_tpu_torch/
csrc/unmasked_attention.cu `attn_fwd_tf32x3_kernel`,
`attn_bwd_dq_tf32x3_kernel` and `attn_bwd_dkv_tf32x3_kernel`: every product
in split TF32 on the tensor cores) on the CPU, before any card runs them.

`tf32x3_attention_model` (tests/torch_attention_cases.py) is their
arithmetic in plain torch: each operand split into TF32 hi + lo (cvt.rna),
three TF32 products per m16n8k8 step, each step's sum rounded toward zero
as the tensor cores round it, every sum started afresh per 64-row tile and
added to the running sum in fp32, and the CUDA-core kernels' rounding
points for the scale, the mask, the softmax and the statistics. It is held
against the JAX package's fp32 Pallas kernels run in interpret mode
(region_attention.py `_plain_fwd`/`_plain_bwd` through `packed_flash_mha`,
`_region_fwd`/`_region_bwd` through `region_flash_mha`, flash_attention.py
`_flash_mha_impl` through `flash_mha`) under the bars the card holds the
kernels to: the output within rtol = atol = 1e-5 (tests/
test_torch_seg_attention.py TOL), dq, dk and dv each within 1e-5
norm-relative (chip_smoke.py BWD_REL), at head widths 32 and 64 on
standard-normal inputs, a peaked softmax (|s| ~ 30) and values of
magnitude up to 8 (tests/torch_attention_cases.py "peaked", "large"),
unmasked and region-masked with fully suppressed rows (those equal the
mean of v). The same model with one TF32 product (`products=1`, what a
plain TF32 kernel computes) misses both bars on every case: the tests
tell the two apart.
"""

import functools

import numpy as np
import pytest
import torch

from torch_attention_cases import tf32x3_attention_model
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL, BWD_REL = 1e-5, 1e-5   # the card's fp32 bars
B, LQ, LKV = 2, 1024, 128       # the smallest shape the JAX gate admits
CASES = ("plain", "peaked", "large")
WIDTHS = (32, 64)               # one head of each width


def _inputs(case: str, dh: int):
    """q, k, v, dO and ids from a seed: the values of the case; ids as in
    tests/test_torch_seg_attention_bwd.py (image 1's q rows with id 1 are
    fully suppressed)."""
    rng = np.random.default_rng(dh + len(case))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, LQ, dh), (B, LKV, dh), (B, LKV, dh), (B, LQ, dh)))
    if case == "peaked":
        q *= 5.6
    elif case == "large":
        v = rng.uniform(-8, 8, v.shape).astype(np.float32)
        do = rng.uniform(-8, 8, do.shape).astype(np.float32)
    rq = rng.choice(np.float32([0, 0.5, 1, 3]), (B, LQ)).astype(np.float32)
    rkv = rng.choice(np.float32([0, 0.5, 1]), (B, LKV)).astype(np.float32)
    rkv[1] = 1.0
    rq[1] = np.where(rng.random(LQ) < 0.5, 1.0, 0.5)
    return q, k, v, do, rq, rkv


@functools.lru_cache(maxsize=None)
def _jax(case: str, dh: int, masked: bool):
    """The inputs and the JAX kernels' o and (dq, dk, dv) on them
    (interpret mode), as torch tensors."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import region_attention as jra

    q, k, v, do, rq, rkv = _inputs(case, dh)
    jnp = jax.numpy
    assert jra.region_flash_supported(LQ, LKV, dh, 1)   # the kernels
    if masked:
        fn = lambda q_, k_, v_: jra.region_flash_mha(
            q_, k_, v_, jnp.asarray(rq), jnp.asarray(rkv), 1)
    else:
        fn = lambda q_, k_, v_: jra.packed_flash_mha(q_, k_, v_, 1)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    t = lambda a: torch.from_numpy(np.array(a))
    return ([t(a) for a in (q, k, v, do, rq, rkv)], t(o),
            [t(g) for g in grads])


def _model(case: str, dh: int, masked: bool, products: int):
    ins, want_o, want_g = _jax(case, dh, masked)
    q, k, v, do, rq, rkv = ins
    ids = (rq, rkv) if masked else (None, None)
    o, *grads = tf32x3_attention_model(q, k, v, 1, *ids, do=do,
                                       products=products)
    return ins, (o, want_o), list(zip(grads, want_g))


def _fwd_ratio(got, want) -> float:
    """The largest |got - want| over the bar FWD_TOL * (1 + |want|)."""
    return ((got - want).abs() / (FWD_TOL * (1 + want.abs()))).max().item()


def _rel(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


PARAMS = [pytest.param(c, dh, m, id=f"{c}-dh{dh}-{'masked' if m else 'plain'}")
          for c in CASES for dh in WIDTHS for m in (False, True)]


@pytest.mark.parametrize("case,dh,masked", PARAMS)
def test_split_tf32_model_matches_jax(case, dh, masked):
    ins, (o, want_o), grads = _model(case, dh, masked, 3)
    assert _fwd_ratio(o, want_o) <= 1.0
    for name, (g, w) in zip(("dq", "dk", "dv"), grads):
        assert _rel(g, w) <= BWD_REL, name
    if masked:   # fully suppressed rows: the mean of v, their dq on its own
        q, k, v, do, rq, rkv = ins
        full = (rq[:, :, None] == rkv[:, None, :]).all(-1)
        assert full.sum() > 0
        mean_v = v.mean(1, keepdim=True).expand(-1, LQ, -1)[full]
        torch.testing.assert_close(o[full], mean_v, rtol=FWD_TOL,
                                   atol=FWD_TOL)
        dq, want_dq = grads[0]
        assert _rel(dq[full], want_dq[full]) <= BWD_REL


@pytest.mark.parametrize("case,dh,masked", PARAMS)
def test_one_tf32_product_misses_the_bar(case, dh, masked):
    _, (o, want_o), grads = _model(case, dh, masked, 1)
    assert _fwd_ratio(o, want_o) > 1.0
    assert min(_rel(g, w) for g, w in grads) > BWD_REL


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("q_shape,lk", [((1, 2, 512, 32), 512),   # full-K
                                        ((1, 1, 1024, 64), 2048)])  # online
def test_flash_mha_model(q_shape, lk, case, products):
    """B5's forward (`flash_mha`): the split-TF32 model within the bar of
    JAX's kernel, one TF32 product outside it."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.ops import flash_attention as jfa

    b, h, lq, dh = q_shape
    rng = np.random.default_rng(lk + dh)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32)
               for n in (lq, lk, lk))
    if case == "peaked":
        q *= 5.6
    elif case == "large":
        v = rng.uniform(-8, 8, v.shape).astype(np.float32)
    want = torch.from_numpy(np.asarray(jfa.flash_mha(
        *map(jax.numpy.asarray, (q, k, v)))))
    flat = lambda a: torch.from_numpy(a).reshape(b * h, -1, dh)
    o = tf32x3_attention_model(flat(q), flat(k), flat(v), 1,
                               products=products).reshape(q_shape)
    ratio = _fwd_ratio(o, want)
    assert ratio <= 1.0 if products == 3 else ratio > 1.0
