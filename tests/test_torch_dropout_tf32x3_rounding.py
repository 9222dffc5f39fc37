"""The rounding points of the fp32 hash-dropout kernels (fudanocr_tpu_torch/
csrc/flash_attention_dropout_tf32x3.cu `attn_dropout_fwd_tf32x3_kernel`,
`attn_dropout_bwd_dq_tf32x3_kernel` and `attn_dropout_bwd_dkv_tf32x3_kernel`:
every product in split TF32 on the tensor cores) on the CPU, before any
card runs them.

`dropout_tf32x3_model` (tests/torch_attention_cases.py) is their
arithmetic in plain torch: each operand split into TF32 hi + lo (cvt.rna),
three TF32 products per m16n8k8 step, each step's sum rounded toward zero
as the tensor cores round it, every sum started afresh per 64-row tile and
added to the running sum in fp32, the dropped probabilities zeroed before
their split for P V, inv_keep / l applied last, and D = dO . o from the
fp32 output in the backward (`KERNEL_D`, what the kernels form; JAX forms
rowsum(keep dP' P)). It is held against the JAX package's fp32 kernels
`_qkv_dropout_fwd` and `_qkv_dropout_bwd` (fudanocr_tpu/ops/
flash_attention.py:505, :528) run in interpret mode, under the bars the
card holds the kernels to: o within rtol = atol = 1e-5, dq, dk and dv each
within 1e-5 norm-relative (chip_smoke.py ATTN_ATOL, GRAD_REL), at
(2, 512, 384) and (2, 768, 384) on standard normals, a peaked softmax (q x
5.6, |s| ~ 30) and v, dO of magnitude up to 8. The same model with one
TF32 product (`products=1`, what a plain TF32 kernel computes) misses both
bars on every case: the tests tell the two apart. The port's plain version
(the CPU path and `kernels=False`) is held to JAX's kernels at the same
bars. On the card the kernels are held against the plain version
(tests/test_torch_flash_attention.py, marked `cuda`).
"""

import functools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.ops import flash_attention as fa
from torch_attention_cases import dropout_tf32x3_model
from torch_threads import one_torch_thread  # noqa: F401

HEADS, RATE, SEED = 4, 0.1, 77
FWD_TOL, BWD_REL = 1e-5, 1e-5   # the card's fp32 bars
D = HEADS * 32
CASES = ("plain", "peaked", "large")
KERNEL_D = "o"   # the kernels' D: dO . o from the fp32 output
PARAMS = [pytest.param(c, l, id=f"{c}-{l}") for c in CASES for l in (512, 768)]


def _inputs(case: str, l: int):
    """fp32 qkv (2, l, 3D) and dO (2, l, D) of the case from a seed."""
    rng = np.random.default_rng(l + len(case))
    qkv = rng.standard_normal((2, l, 3 * D)).astype(np.float32)
    do = rng.standard_normal((2, l, D)).astype(np.float32)
    if case == "peaked":
        qkv[..., :D] *= 5.6
    elif case == "large":
        qkv[..., 2 * D:] = rng.uniform(-8, 8, (2, l, D))
        do = rng.uniform(-8, 8, do.shape).astype(np.float32)
    return qkv, do


@functools.lru_cache(maxsize=None)
def _jax(case: str, l: int):
    """The inputs and the JAX kernels' o and dqkv on them (interpret mode),
    as torch tensors."""
    jnp = pytest.importorskip("jax.numpy")
    from fudanocr_tpu.ops import flash_attention as jfa

    qkv, do = _inputs(case, l)
    o = jfa._qkv_dropout_fwd(jnp.asarray(qkv), jnp.uint32(SEED), HEADS, RATE)
    dqkv = jfa._qkv_dropout_bwd(jnp.asarray(qkv), jnp.asarray(do),
                                jnp.uint32(SEED), HEADS, RATE)
    t = lambda a: torch.from_numpy(np.array(a))
    return t(qkv), t(do), t(o), t(dqkv)


def _fwd_ratio(got, want) -> float:
    """The largest |got - want| over the bar FWD_TOL * (1 + |want|)."""
    return ((got - want).abs() / (FWD_TOL * (1 + want.abs()))).max().item()


def _parts_rel(got, want) -> list:
    """Norm-relative distances of dq, dk and dv."""
    return [((got[..., i * D:(i + 1) * D] - want[..., i * D:(i + 1) * D])
             .norm() / want[..., i * D:(i + 1) * D].norm()).item()
            for i in range(3)]


def _model(case: str, l: int, products: int, dsum: str = KERNEL_D):
    qkv, do, want_o, want = _jax(case, l)
    o, *grads = dropout_tf32x3_model(*fa._columns(qkv), do, SEED, HEADS,
                                     RATE, products=products, dsum=dsum)
    return (o, want_o), (torch.cat(grads, -1), want)


@pytest.mark.parametrize("case,l", PARAMS)
def test_split_tf32_model_matches_jax(case, l):
    (o, want_o), (dqkv, want) = _model(case, l, 3)
    assert _fwd_ratio(o, want_o) <= 1.0
    parts = _parts_rel(dqkv, want)
    assert max(parts) <= BWD_REL, parts


@pytest.mark.parametrize("case,l", PARAMS)
def test_one_tf32_product_misses_the_bar(case, l):
    (o, want_o), (dqkv, want) = _model(case, l, 1)
    assert _fwd_ratio(o, want_o) > 1.0
    parts = _parts_rel(dqkv, want)
    assert min(parts) > BWD_REL, parts


@pytest.mark.parametrize("case", CASES)
def test_kernel_d_form_meets_the_bar_as_jax_form_does(case):
    """The kernels take D = dO . o (`KERNEL_D`) where JAX forms D' =
    rowsum(keep dP' P): equal in exact arithmetic, and in fp32 the
    rounding model stays within the gradient bar with either, also at a
    peaked softmax where dS = P (dP' - D) cancels (bf16 needs D', tests/
    test_torch_dropout_rounding.py)."""
    for dsum in (KERNEL_D, "dprime"):
        _, (dqkv, want) = _model(case, 512, 3, dsum=dsum)
        parts = _parts_rel(dqkv, want)
        assert max(parts) <= BWD_REL, (dsum, parts)


@pytest.mark.parametrize("case,l", PARAMS)
def test_plain_version_matches_jax(case, l):
    """The port's plain version and its autograd gradient against JAX's
    fp32 kernels at the fp32 bars."""
    qkv, do, want_o, want = _jax(case, l)
    x = qkv.clone().requires_grad_()
    o = fa.flash_mha_qkv_packed_dropout_reference(x, SEED, HEADS, RATE)
    (dqkv,) = torch.autograd.grad(o, x, do)
    assert _fwd_ratio(o.detach(), want_o) <= 1.0
    parts = _parts_rel(dqkv, want)
    assert max(parts) <= BWD_REL, parts
