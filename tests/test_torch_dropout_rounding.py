"""The rounding points of the bf16 hash-dropout kernels (fudanocr_tpu_torch/
csrc/flash_attention_dropout.cu `attn_dropout_fwd_mma_kernel`,
`attn_dropout_dsum_mma_kernel` and `attn_dropout_bwd_mma_kernel`) on the
CPU, before any card runs them.

`dropout_rounding_model` (tests/torch_attention_cases.py) is their
arithmetic in plain torch: the kept probabilities rounded to bf16 for the
value product in the forward; in the backward D' = rowsum(keep P dP) in
fp32, keep * P and dS rounded to bf16 for dV and dK, and dS split into a
bf16 pair for dQ, where the JAX package's kernels multiply in fp32. It is
held against those kernels, `_qkv_dropout_fwd` and `_qkv_dropout_bwd`
(fudanocr_tpu/ops/flash_attention.py:505, :528) run in interpret mode on
bf16 inputs at (2, 512, 384) and (2, 768, 384), under the bars the card
uses (2e-2 absolute forward, 1e-2 norm-relative dqkv). The inputs are the
cases of tests/torch_attention_cases.py: standard normals, and two that
peak the softmax ("rising", "x16"), where dS = P (dP - D) cancels and a
bf16 D or dS shows. The backward stays within half the bar (5e-3) in dq,
dk and dv each, the margin under which a product keeps one bf16 rounding
rather than a hi/lo split.
The port's plain version (the CPU path and `kernels=False`) is held to
JAX's kernels on the same inputs. On the card the kernels are held against
the model and the plain version (tests/test_torch_flash_attention.py and
test_torch_packed_attention.py, marked `cuda`).
"""

import functools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.ops import flash_attention as fa
from torch_attention_cases import dropout_rounding_model, edge_qkv_fused
from torch_threads import one_torch_thread  # noqa: F401

HEADS, RATE, SEED = 4, 0.1, 77
FWD_ATOL, BWD_REL = 2e-2, 1e-2   # chip_smoke.py ATTN_ATOL, GRAD_REL (bf16)
# the plain version computes JAX's backward in fp32 as JAX does: its
# distance is summation order and the outputs' rounding (measured <= 1e-4)
PLAIN_REL = 1e-3
CASES = ("plain", "rising", "x16")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@functools.lru_cache(maxsize=None)
def _jax_kernels(case: str, l: int):
    """bf16 qkv (2, l, 384) of the edge case `case` and dO from a seed, and
    the JAX kernels' o and dqkv on them (interpret mode), as torch
    tensors."""
    jnp = pytest.importorskip("jax.numpy")
    from fudanocr_tpu.ops import flash_attention as jfa

    qkv = edge_qkv_fused(case, 2, l, HEADS * 32, "cpu", seed=l)
    do = torch.randn(2, l, HEADS * 32, generator=torch.Generator()
                     .manual_seed(l + 1)).to(torch.bfloat16)
    jq, jd = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qkv, do))
    o = jfa._qkv_dropout_fwd(jq, jnp.uint32(SEED), HEADS, RATE)
    dqkv = jfa._qkv_dropout_bwd(jq, jd, jnp.uint32(SEED), HEADS, RATE)

    def torch_bf16(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)

    return qkv, do, torch_bf16(o), torch_bf16(dqkv)


def _model(qkv: torch.Tensor, do: torch.Tensor):
    """(o, dqkv) of the rounding model on the fused buffer's columns."""
    q, k, v = fa._columns(qkv)
    o, dq, dk, dv = dropout_rounding_model(q, k, v, do, SEED, HEADS, RATE)
    return o, torch.cat([dq, dk, dv], -1)


def _parts_rel(got: torch.Tensor, want: torch.Tensor) -> list:
    """Norm-relative distances of dq, dk and dv."""
    d = HEADS * 32
    return [_rel(got[..., i * d:(i + 1) * d], want[..., i * d:(i + 1) * d])
            for i in range(3)]


@pytest.mark.parametrize("l", [512, 768])
@pytest.mark.parametrize("case", CASES)
def test_forward_rounding_matches_jax(case, l):
    qkv, do, want, _ = _jax_kernels(case, l)
    o, _ = _model(qkv, do)
    err = (o.float() - want.float()).abs().max().item()
    assert err <= FWD_ATOL, err


@pytest.mark.parametrize("l", [512, 768])
@pytest.mark.parametrize("case", CASES)
def test_backward_rounding_matches_jax(case, l):
    qkv, do, _, want = _jax_kernels(case, l)
    _, dqkv = _model(qkv, do)
    rel = _rel(dqkv, want)
    assert rel <= BWD_REL / 2, rel
    parts = _parts_rel(dqkv, want)   # dq, dk, dv each
    assert max(parts) <= BWD_REL / 2, parts


@pytest.mark.parametrize("l", [512, 768])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax(case, l):
    """The port's plain version and its autograd gradient against JAX's
    kernels: the forward under the bf16 bar, dq, dk and dv each within
    PLAIN_REL."""
    qkv, do, want_o, want = _jax_kernels(case, l)
    x = qkv.clone().requires_grad_()
    o = fa.flash_mha_qkv_packed_dropout_reference(x, SEED, HEADS, RATE)
    (dqkv,) = torch.autograd.grad(o, x, do)
    assert (o.float() - want_o.float()).abs().max().item() <= FWD_ATOL
    parts = _parts_rel(dqkv, want)
    assert max(parts) <= PLAIN_REL, parts


@pytest.mark.parametrize("heads,l", [(4, 256), (2, 384)])
def test_model_matches_the_plain_version(heads, l):
    """The model against the port's plain version (fp32 inside, the
    probabilities rounded for the forward's value product) and its
    autograd gradient, under the same bars."""
    gen = torch.Generator().manual_seed(heads * l)
    qkv = torch.randn(2, l, 3 * heads * 32, generator=gen).to(torch.bfloat16)
    do = torch.randn(2, l, heads * 32, generator=gen).to(torch.bfloat16)
    q, k, v = fa._columns(qkv)
    o, dq, dk, dv = dropout_rounding_model(q, k, v, do, SEED, heads, RATE)
    x = qkv.clone().requires_grad_()
    want = fa.flash_mha_qkv_packed_dropout_reference(x, SEED, heads, RATE)
    (dqkv,) = torch.autograd.grad(want, x, do)
    assert (o.float() - want.float()).abs().max().item() <= FWD_ATOL
    assert _rel(torch.cat([dq, dk, dv], -1), dqkv) <= BWD_REL / 2
