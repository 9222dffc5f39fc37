"""Attention over lane-packed (B, L, H*dh) operands, unmasked and
region-masked: Hopper kernels (forward and backward) + plain twins.

Port of fudanocr_tpu/ops/region_attention.py: `region_flash_supported`
(:44-54) and `packed_flash_supported` (:275, the same gate),
`packed_flash_mha` (:340, Pallas forward `_plain_fwd` :280, backward
`_plain_bwd` :306) and `region_flash_mha` (:239, Pallas forward
`_region_fwd` :167, backward `_region_bwd` :201). q is (B, Lq, H*dh), k
and v are (B, Lkv, H*dh), head h lives in columns [h*dh, (h+1)*dh), and
the result is (B, Lq, H*dh):

    o_h = softmax(q_h k_h^T / sqrt(dh) + M) v_h

with M = 0 for `packed_flash_mha`, and for `region_flash_mha`
M_ij = -1e10 where the fp32 region ids rq (B, Lq) and rkv (B, Lkv) are
EQUAL (the det-guided reference suppresses same-region pairs). The mask is
added to the scaled fp32 scores before the row max, so every suppressed
score with |s| < 512 rounds to exactly -1e10 (the fp32 spacing there is
1024) and a row whose pairs are all suppressed is uniform: its output is
the mean of v. JAX, the reference and the port agree on that (the JAX
docstring's "plain softmax of its scores" does not hold in fp32). Ids carry
no gradient, as in JAX.

The wrappers run the plain versions on CPU tensors, through
`_PlainPackedAttention`: the plain forward, and as its backward the plain
backward at the JAX `_bwd_body`'s rounding points (autograd through the
forward rounds dq differently, 1.3e-2 from JAX's bf16 backward on a rising
row max). On CUDA tensors they launch the strided kernels of
csrc/unmasked_attention.cu, the family `flash_mha` (ops/flash_attention.py)
launches for the (B, H, L, dh) layout: without a gradient to take, the
forward through `unmasked_packed_fwd` or `region_packed_fwd` (its MASKED
variant); with one, `_PackedAttention`, whose forward is the training
forward of the same wrappers (`stats=True`: o in fp32 and each row's max
and 1/denominator saved) and whose backward is `unmasked_packed_bwd` or
`region_packed_bwd`. They raise on what the kernels do not take and never
fall back. `packed_flash_mha_bwd_reference` and
`region_flash_mha_bwd_reference` are the plain backwards, at the rounding
points of the JAX `_bwd_body` (:96-142).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from fudanocr_tpu_torch.ops.flash_attention import (check_unmasked,
                                                    check_unmasked_shape,
                                                    flash_mha_reference)


NEG = -1e10   # the reference's suppression constant (cascade_mit.py:4973)
BWD_KEY_ROWS = 128        # keys per dK/dV block: Lkv must be a multiple
BWD_TARGET_BLOCKS = 528   # dK/dV blocks to aim for: 4 per SM of an H100

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
    at a time bounds the (B, Lq, Lkv) temporaries. Autograd differentiates
    it (the row max is detached, which is exact: the output does not
    depend on the shift)."""
    dh = q.shape[-1] // heads
    scale = 1.0 / math.sqrt(dh)
    neg = region_mask(rq, rkv)
    outs = []
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        s = torch.matmul(q[..., cols].float(),
                         k[..., cols].float().transpose(1, 2))
        s.mul_(scale).add_(neg)
        s.sub_(s.detach().amax(-1, keepdim=True)).exp_()
        denom = s.sum(-1, keepdim=True)
        o = torch.matmul(s.to(v.dtype).float(), v[..., cols].float()) / denom
        outs.append(o.to(q.dtype))
    return torch.cat(outs, -1)


def _bwd_reference(q, k, v, neg, do, heads) -> Grads:
    """The JAX `_bwd_body` (region_attention.py:96-142), one head at a
    time: probs = softmax(s + neg) in fp32, dv = probs^T dO,
    dp = dO v^T, ds = probs (dp - rowsum(dp probs)), dq = ds k * scale,
    dk = ds^T q * scale, each cast to its operand's dtype."""
    dh = q.shape[-1] // heads
    scale = 1.0 / math.sqrt(dh)
    dqs, dks, dvs = [], [], []
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qc, kh, vh, doc = (t[..., cols].float() for t in (q, k, v, do))
        s = torch.matmul(qc, kh.transpose(1, 2)).mul_(scale)
        if neg is not None:
            s.add_(neg)
        s.sub_(s.amax(-1, keepdim=True)).exp_()
        probs = s.div_(s.sum(-1, keepdim=True))
        dvs.append(torch.matmul(probs.transpose(1, 2), doc).to(v.dtype))
        dp = torch.matmul(doc, vh.transpose(1, 2))
        ds = dp.sub_((dp * probs).sum(-1, keepdim=True)).mul_(probs)
        del probs, s
        dqs.append((torch.matmul(ds, kh) * scale).to(q.dtype))
        dks.append((torch.matmul(ds.transpose(1, 2), qc) * scale)
                   .to(k.dtype))
    return torch.cat(dqs, -1), torch.cat(dks, -1), torch.cat(dvs, -1)


def packed_flash_mha_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, do: torch.Tensor,
                                   heads: int) -> Grads:
    """The plain backward of `packed_flash_mha`: (dq, dk, dv) for the
    output gradient `do` (B, Lq, H*dh), as the JAX `_plain_bwd` computes
    them."""
    return _bwd_reference(q, k, v, None, do, heads)


def region_flash_mha_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, rq: torch.Tensor,
                                   rkv: torch.Tensor, do: torch.Tensor,
                                   heads: int) -> Grads:
    """The plain backward of `region_flash_mha`: (dq, dk, dv), as the JAX
    `_region_bwd` computes them (the ids get none)."""
    return _bwd_reference(q, k, v, region_mask(rq, rkv), do, heads)


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


def _check_ids(rq, rkv, b, lq, lk, device, what) -> None:
    for name, t, shape in (("rq", rq, (b, lq)), ("rkv", rkv, (b, lk))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"{shape} on {device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, strides {t.stride()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_stats(lib, q, k, v, rq, rkv, heads: int):
    """The training forward: (o at q's dtype, o fp32, row max, 1/row sum),
    the statistics (B, H, Lq) fp32. In bf16 the kernel writes o, the
    probabilities rounded to bf16 for the value product as JAX rounds them,
    and o fp32 from the fp32 probabilities, which the backward's D takes;
    in fp32 the two are one tensor."""
    from fudanocr_tpu_torch.ops._build import check

    b, lq, d = q.shape
    dh = d // heads
    bf16 = q.dtype == torch.bfloat16
    o32 = torch.empty((b, lq, d), dtype=torch.float32, device=q.device)
    o = torch.empty((b, lq, d), dtype=q.dtype, device=q.device) if bf16 \
        else o32
    m = torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
    inv = torch.empty_like(m)
    check(lib.attn_packed_fwd_stats(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rq), _ptr(rkv),
        o.data_ptr() if bf16 else None, o32.data_ptr(), m.data_ptr(),
        inv.data_ptr(), b, heads, lq, k.shape[1], dh, q.stride(1),
        k.stride(1), v.stride(1), 1.0 / math.sqrt(dh), int(bf16),
        torch.cuda.current_stream().cuda_stream), "attn_packed_fwd_stats")
    return o, o32, m, inv


def unmasked_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, stats: bool = False):
    """Launch the kernel on packed operands: rows with unit feature stride,
    any row stride (a column slice of a wider buffer is read in place), an
    image's rows one after another. Returns a contiguous (B, Lq, D); with
    `stats`, the training forward's (o, o fp32, row max, 1/row sum).
    `unmasked_packed_fwd.launches` counts launches."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    b, lq, lk, d = _check_packed(q, k, v, heads, "packed_flash_mha")
    dh = d // heads
    lib = load_library()
    with torch.cuda.device(q.device):
        unmasked_packed_fwd.launches += 1
        if stats:
            return _fwd_stats(lib, q, k, v, None, None, heads)
        o = torch.empty((b, lq, d), dtype=q.dtype, device=q.device)
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
                      heads: int, stats: bool = False):
    """Launch the MASKED kernel on packed operands (as `unmasked_packed_fwd`
    takes them) and contiguous float32 ids rq (B, Lq), rkv (B, Lkv) on q's
    device. Returns a contiguous (B, Lq, D), or with `stats` the training
    forward's four tensors. `region_packed_fwd.launches` counts launches."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    what = "region_flash_mha"
    b, lq, lk, d = _check_packed(q, k, v, heads, what)
    dh = d // heads
    _check_ids(rq, rkv, b, lq, lk, q.device, what)
    lib = load_library()
    with torch.cuda.device(q.device):
        region_packed_fwd.launches += 1
        if stats:
            return _fwd_stats(lib, q, k, v, rq, rkv, heads)
        o = torch.empty((b, lq, d), dtype=q.dtype, device=q.device)
        check(lib.attn_region_packed_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rq.data_ptr(),
            rkv.data_ptr(), o.data_ptr(), b, heads, lq, lk, dh, q.stride(1),
            k.stride(1), v.stride(1), o.stride(1), 1.0 / math.sqrt(dh),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream),
            "attn_region_packed_fwd")
    return o


region_packed_fwd.launches = 0


def bwd_q_chunk(b: int, heads: int, lq: int, lk: int) -> int:
    """q rows per dK/dV block of the backward: Lq split into slices of a
    multiple of 64 rows so that about BWD_TARGET_BLOCKS blocks run (each
    slice writes fp32 partial sums)."""
    kv_blocks = b * heads * (lk // BWD_KEY_ROWS)
    tiles = lq // 64
    splits = max(1, min(tiles, -(-BWD_TARGET_BLOCKS // kv_blocks)))
    return -(-tiles // splits) * 64


def _check_bwd_shape(lk: int, what: str) -> None:
    if lk % BWD_KEY_ROWS:
        raise ValueError(f"{what}: the backward kernel needs Lkv a multiple "
                         f"of {BWD_KEY_ROWS}, got {lk}")


def _packed_bwd(q, k, v, rq, rkv, o32, do, m, inv, heads: int,
                what: str, counter) -> Grads:
    from fudanocr_tpu_torch.ops._build import check, load_library

    b, lq, lk, d = _check_packed(q, k, v, heads, what)
    _check_bwd_shape(lk, what)
    if rq is not None:
        _check_ids(rq, rkv, b, lq, lk, q.device, what)
    for name, t, shape, dtype in (
            ("o32", o32, (b, lq, d), torch.float32),
            ("do", do, (b, lq, d), q.dtype),
            ("m", m, (b, heads, lq), torch.float32),
            ("inv", inv, (b, heads, lq), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not fit q {tuple(q.shape)} "
                             f"{q.dtype}")
    dh = d // heads
    chunk = bwd_q_chunk(b, heads, lq, lk)
    splits = -(-lq // chunk)
    lib = load_library()
    with torch.cuda.device(q.device):
        f32 = dict(dtype=torch.float32, device=q.device)
        delta = torch.empty((b, heads, lq), **f32)
        dk_part = torch.empty((splits, b, lk, d), **f32)
        dv_part = torch.empty((splits, b, lk, d), **f32)
        dq = torch.empty((b, lq, d), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, lk, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        counter.launches += 1
        check(lib.attn_packed_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rq), _ptr(rkv),
            o32.data_ptr(), do.data_ptr(), m.data_ptr(), inv.data_ptr(),
            delta.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, heads, lq, lk, dh,
            q.stride(1), k.stride(1), v.stride(1), chunk,
            1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "attn_packed_bwd")
    return dq, dk, dv


def unmasked_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o32: torch.Tensor, do: torch.Tensor,
                        m: torch.Tensor, inv: torch.Tensor,
                        heads: int) -> Grads:
    """Launch the backward kernel of `packed_flash_mha`: (dq, dk, dv),
    contiguous, at q's dtype, from the operands, the training forward's
    o32, m, inv and the contiguous output gradient `do`.
    `unmasked_packed_bwd.launches` counts launches."""
    return _packed_bwd(q, k, v, None, None, o32, do, m, inv, heads,
                       "packed_flash_mha backward", unmasked_packed_bwd)


unmasked_packed_bwd.launches = 0


def region_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      rq: torch.Tensor, rkv: torch.Tensor,
                      o32: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
                      inv: torch.Tensor, heads: int) -> Grads:
    """Launch the MASKED backward kernel of `region_flash_mha` (as
    `unmasked_packed_bwd`, plus the ids). `region_packed_bwd.launches`
    counts launches."""
    return _packed_bwd(q, k, v, rq, rkv, o32, do, m, inv, heads,
                       "region_flash_mha backward", region_packed_bwd)


region_packed_bwd.launches = 0


class _PackedAttention(torch.autograd.Function):
    """The kernels' forward and backward of both packed routes (rq is None:
    unmasked). CUDA tensors only: the launch wrappers refuse others."""

    @staticmethod
    def forward(ctx, q, k, v, rq, rkv, heads):
        what = "packed_flash_mha" if rq is None else "region_flash_mha"
        _check_bwd_shape(k.shape[1], what)   # refuse before the forward
        if rq is None:
            o, o32, m, inv = unmasked_packed_fwd(q, k, v, heads, stats=True)
        else:
            o, o32, m, inv = region_packed_fwd(q, k, v, rq, rkv, heads,
                                               stats=True)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, rq, rkv, o32, m, inv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, rq, rkv, o32, m, inv = ctx.saved_tensors
        do = do.contiguous()
        if rq is None:
            dq, dk, dv = unmasked_packed_bwd(q, k, v, o32, do, m, inv,
                                             ctx.heads)
        else:
            dq, dk, dv = region_packed_bwd(q, k, v, rq, rkv, o32, do, m, inv,
                                           ctx.heads)
        return dq, dk, dv, None, None, None


class _PlainPackedAttention(torch.autograd.Function):
    """The CPU route of both packed wrappers (rq is None: unmasked): the
    plain forward, and `_bwd_reference` as its backward, which is JAX's
    `_bwd_body` for both dtypes (D from the fp32 probabilities)."""

    @staticmethod
    def forward(ctx, q, k, v, rq, rkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, rq, rkv)
        if rq is None:
            return packed_flash_mha_reference(q, k, v, heads)
        return region_flash_mha_reference(q, k, v, rq, rkv, heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, rq, rkv = ctx.saved_tensors
        neg = None if rq is None else region_mask(rq, rkv)
        dq, dk, dv = _bwd_reference(q, k, v, neg, do, ctx.heads)
        return dq, dk, dv, None, None, None


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def packed_flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """Unmasked multi-head attention over packed (B, L, H*dh) operands ->
    (B, Lq, H*dh), differentiable in q, k and v.

    CPU tensors run the plain version (`_PlainPackedAttention`). CUDA
    tensors run the kernels (built at first use, see ops/_build.py) and
    raise on what they do not take: a dtype other than float32/bfloat16, a
    head width other than 32 or 64, Lq not a multiple of 128 or Lkv of 64
    (of 128 when a gradient is to be taken), or a feature stride other
    than 1."""
    if q.device.type == "cpu":
        return _PlainPackedAttention.apply(q, k, v, None, None, heads)
    if q.device.type != "cuda":
        raise ValueError(f"packed_flash_mha: no kernel for {q.device}")
    if _needs_grad(q, k, v):
        return _PackedAttention.apply(q, k, v, None, None, heads)
    return unmasked_packed_fwd(q, k, v, heads)


def region_flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rq: torch.Tensor, rkv: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """Region-masked multi-head attention over packed (B, L, H*dh) operands
    -> (B, Lq, H*dh): pairs whose fp32 ids rq (B, Lq), rkv (B, Lkv) are
    equal get -1e10 added to their score (see the module docstring).
    Differentiable in q, k and v; the ids get no gradient.

    CPU tensors run the plain version (`_PlainPackedAttention`). CUDA
    tensors run the MASKED kernels and raise on what they do not take:
    what `packed_flash_mha` refuses, or ids that are not contiguous float32
    of shapes (B, Lq) and (B, Lkv) on q's device."""
    if q.device.type == "cpu":
        return _PlainPackedAttention.apply(q, k, v, rq, rkv, heads)
    if q.device.type != "cuda":
        raise ValueError(f"region_flash_mha: no kernel for {q.device}")
    if _needs_grad(q, k, v):
        return _PackedAttention.apply(q, k, v, rq, rkv, heads)
    return region_packed_fwd(q, k, v, rq, rkv, heads)
