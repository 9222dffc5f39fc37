"""Attention over lane-packed (B, L, H*dh) operands, unmasked and
region-masked: Hopper kernel (forward) + plain twins.

Port of fudanocr_tpu/ops/region_attention.py: `region_flash_supported`
(:44-54) and `packed_flash_supported` (:275, the same gate),
`packed_flash_mha` (:340, Pallas forward `_plain_fwd` :280) and
`region_flash_mha` (:239, Pallas forward `_region_fwd` :167). q is
(B, Lq, H*dh), k and v are (B, Lkv, H*dh), head h lives in columns
[h*dh, (h+1)*dh), and the result is (B, Lq, H*dh):

    o_h = softmax(q_h k_h^T / sqrt(dh) + M) v_h

with M = 0 for `packed_flash_mha`, and for `region_flash_mha`
M_ij = -1e10 where the fp32 region ids rq (B, Lq) and rkv (B, Lkv) are
EQUAL (the det-guided reference suppresses same-region pairs). The mask is
added to the scaled fp32 scores before the row max, so every suppressed
score with |s| < 512 rounds to exactly -1e10 (the fp32 spacing there is
1024) and a row whose pairs are all suppressed is uniform: its output is
the mean of v. JAX, the reference and the port agree on that (the JAX
docstring's "plain softmax of its scores" does not hold in fp32).

The wrappers run the plain versions on CPU tensors. On CUDA tensors they
launch the strided kernel of csrc/unmasked_attention.cu, the one
`flash_mha` (ops/flash_attention.py) launches for the (B, H, L, dh)
layout: through `unmasked_packed_fwd`, or `region_packed_fwd` for its
MASKED variant. They raise on what it does not take and never fall back. Forward only: the Pallas
backwards `_plain_bwd` (:306) and `_region_bwd` (:201) are the segmentation
training slice's.
"""

from __future__ import annotations

import math

import torch

from fudanocr_tpu_torch.ops.flash_attention import (check_unmasked,
                                                    check_unmasked_shape,
                                                    flash_mha_reference)


NEG = -1e10   # the reference's suppression constant (cascade_mit.py:4973)


def region_flash_supported(lq: int, lkv: int, d: int, heads: int) -> bool:
    """CascadeMiT's gate for the packed and region routes: the device-side
    condition of the JAX package's `region_flash_supported`
    (region_attention.py:44-54), without its bound for CPU interpret
    mode."""
    return (lq >= 1024 and lq % 256 == 0
            and 128 <= lkv <= 2048 and lkv % 128 == 0
            and d % heads == 0 and (d // heads) % 8 == 0 and d <= 512)


packed_flash_supported = region_flash_supported   # the JAX gate is one


def region_mask(rq: torch.Tensor, rkv: torch.Tensor) -> torch.Tensor:
    """Ids (B, Lq), (B, Lkv) -> the (B, Lq, Lkv) additive float32 mask:
    -1e10 where the ids are equal, else 0."""
    same = rq.float()[:, :, None] == rkv.float()[:, None, :]
    return torch.where(same, torch.tensor(NEG, device=rq.device),
                       torch.tensor(0.0, device=rq.device))


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> the (B, H, L, dh) view."""
    b, l, d = x.shape
    return x.view(b, l, heads, d // heads).transpose(1, 2)


def packed_flash_mha_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int) -> torch.Tensor:
    """The plain PyTorch version, at the JAX kernel's rounding points (see
    `flash_mha_reference`), all heads at once."""
    o = flash_mha_reference(_heads(q, heads), _heads(k, heads),
                            _heads(v, heads))
    return o.transpose(1, 2).reshape(q.shape)


def region_flash_mha_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rq: torch.Tensor,
                               rkv: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """The plain PyTorch version of `region_flash_mha`, at the JAX kernel's
    rounding points (`_fwd_body`, region_attention.py:63-81): fp32 scores
    times the scale, plus where(rq == rkv, -1e10, 0) in fp32, row max, exp,
    the unnormalised probabilities rounded to v's dtype for the value
    product with fp32 accumulation, divided by the fp32 row sum. One head
    at a time bounds the (B, Lq, Lkv) temporaries."""
    dh = q.shape[-1] // heads
    scale = 1.0 / math.sqrt(dh)
    neg = region_mask(rq, rkv)
    outs = []
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        s = torch.matmul(q[..., cols].float(),
                         k[..., cols].float().transpose(1, 2))
        s.mul_(scale).add_(neg)
        s.sub_(s.amax(-1, keepdim=True)).exp_()
        denom = s.sum(-1, keepdim=True)
        o = torch.matmul(s.to(v.dtype).float(), v[..., cols].float()) / denom
        outs.append(o.to(q.dtype))
    return torch.cat(outs, -1)


def _check_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads: int, what: str) -> tuple:
    """Raise on packed operands the kernel does not take; (B, Lq, Lkv, D)."""
    check_unmasked(q, k, v, what)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2] \
            or heads < 1 or q.shape[2] % heads:
        raise ValueError(f"{what} takes q (B, Lq, D) and k, v (B, Lkv, D) "
                         f"with D a multiple of heads={heads}, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // heads
    check_unmasked_shape(b, heads, lq, lk, dh, what)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if b > 1 and t.stride(0) != t.shape[1] * t.stride(1):
            raise ValueError(f"{what}: {name}'s images are not one after "
                             f"another (strides {t.stride()})")
    return b, lq, lk, d


def unmasked_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Launch the kernel on packed operands: rows with unit feature stride,
    any row stride (a column slice of a wider buffer is read in place), an
    image's rows one after another. Returns a contiguous (B, Lq, D).
    `unmasked_packed_fwd.launches` counts launches."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    b, lq, lk, d = _check_packed(q, k, v, heads, "packed_flash_mha")
    dh = d // heads
    lib = load_library()
    with torch.cuda.device(q.device):
        o = torch.empty((b, lq, d), dtype=q.dtype, device=q.device)
        unmasked_packed_fwd.launches += 1
        check(lib.attn_unmasked_packed_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, heads,
            lq, lk, dh, q.stride(1), k.stride(1), v.stride(1), o.stride(1),
            1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream),
            "attn_unmasked_packed_fwd")
    return o


unmasked_packed_fwd.launches = 0


def region_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      rq: torch.Tensor, rkv: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """Launch the MASKED kernel on packed operands (as `unmasked_packed_fwd`
    takes them) and contiguous float32 ids rq (B, Lq), rkv (B, Lkv) on q's
    device. Returns a contiguous (B, Lq, D). `region_packed_fwd.launches`
    counts launches."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    what = "region_flash_mha"
    b, lq, lk, d = _check_packed(q, k, v, heads, what)
    dh = d // heads
    for name, t, shape in (("rq", rq, (b, lq)), ("rkv", rkv, (b, lk))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"{shape} on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, strides {t.stride()}")
    lib = load_library()
    with torch.cuda.device(q.device):
        o = torch.empty((b, lq, d), dtype=q.dtype, device=q.device)
        region_packed_fwd.launches += 1
        check(lib.attn_region_packed_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rq.data_ptr(),
            rkv.data_ptr(), o.data_ptr(), b, heads, lq, lk, dh, q.stride(1),
            k.stride(1), v.stride(1), o.stride(1), 1.0 / math.sqrt(dh),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream),
            "attn_region_packed_fwd")
    return o


region_packed_fwd.launches = 0


def packed_flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """Unmasked multi-head attention over packed (B, L, H*dh) operands ->
    (B, Lq, H*dh).

    CPU tensors run the plain version. CUDA tensors run the kernel (built at
    first use, see ops/_build.py) and raise on what it does not take: a
    dtype other than float32/bfloat16, a head width other than 32 or 64, Lq
    not a multiple of 128 or Lkv of 64, a feature stride other than 1, or a
    gradient to be taken."""
    if q.device.type == "cpu":
        return packed_flash_mha_reference(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"packed_flash_mha: no kernel for {q.device}")
    return unmasked_packed_fwd(q, k, v, heads)


def region_flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rq: torch.Tensor, rkv: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """Region-masked multi-head attention over packed (B, L, H*dh) operands
    -> (B, Lq, H*dh): pairs whose fp32 ids rq (B, Lq), rkv (B, Lkv) are
    equal get -1e10 added to their score (see the module docstring).

    CPU tensors run the plain version. CUDA tensors run the MASKED kernel
    and raise on what it does not take: what `packed_flash_mha` refuses,
    ids that are not contiguous float32 of shapes (B, Lq) and (B, Lkv) on
    q's device, or a gradient to be taken."""
    if q.device.type == "cpu":
        return region_flash_mha_reference(q, k, v, rq, rkv, heads)
    if q.device.type != "cuda":
        raise ValueError(f"region_flash_mha: no kernel for {q.device}")
    return region_packed_fwd(q, k, v, rq, rkv, heads)
