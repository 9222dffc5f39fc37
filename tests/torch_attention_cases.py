"""Operands for the edge cases of the bf16 tensor-core attention kernels
(fudanocr_tpu_torch/csrc/unmasked_attention.cu `attn_fwd_mma_kernel`, and
the dropout kernels of csrc/flash_attention_dropout.cu), shared by the
`cuda` tests of tests/test_torch_seg_attention.py,
test_torch_qkv_attention.py, test_torch_packed_attention.py and
test_torch_flash_attention.py, and `dropout_rounding_model`, the bf16
dropout kernels' arithmetic in plain torch. Each case is made on the CPU
from a seed, then moved to the card in bf16:

* "plain": standard normals;
* "odd": the same values as column slices of wider buffers at odd element
  offsets and odd row strides, which rule out the kernel's 16-byte copies
  (its 2-byte copy variant runs);
* "rising": positive q and keys whose mean grows with the key index, so the
  running row max rises tile after tile and every row's max lies in the
  last key tile (the online softmax's rescale path);
* "x16": q scaled by 16, scores of magnitude up to ~60 (large |s|).
"""

import math

import torch

from fudanocr_tpu_torch.ops import flash_attention as fa

CASES = ("plain", "odd", "rising", "x16")


def _values(case: str, b: int, lq: int, lkv: int, d: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, d, generator=gen) for n in (lq, lkv, lkv))
    if case == "rising":
        q = q.abs() + 0.5
        k = 0.3 * k + torch.linspace(0.0, 2.0, lkv)[None, :, None]
    elif case == "x16":
        q = 16 * q
    return q, k, v


def _slices(buf: torch.Tensor, widths, offset: int = 1):
    """Column slices of `buf` of the given widths, the first at `offset`."""
    out = []
    for w in widths:
        out.append(buf[..., offset:offset + w])
        offset += w
    return out


def edge_qkv(case: str, b: int, lq: int, lkv: int, d: int, device,
             seed: int = 0):
    """bf16 q (B, Lq, D) and k, v (B, Lkv, D) on `device`."""
    q, k, v = (t.to(torch.bfloat16) for t in _values(case, b, lq, lkv, d,
                                                     seed))
    if case == "odd":
        (q,) = _slices(torch.cat([torch.zeros(b, lq, 1, dtype=q.dtype), q],
                                 -1).to(device), (d,))
        kv = torch.cat([torch.zeros(b, lkv, 1, dtype=k.dtype), k, v], -1)
        k, v = _slices(kv.to(device), (d, d))
        return q, k, v
    return q.to(device), k.to(device), v.to(device)


def edge_qkv_fused(case: str, b: int, l: int, d: int, device,
                   seed: int = 0) -> torch.Tensor:
    """A bf16 (B, L, 3D) [q | k | v] buffer on `device` (for "odd", the
    columns 1.. of a (B, L, 3D + 1) buffer)."""
    qkv = torch.cat([t.to(torch.bfloat16)
                     for t in _values(case, b, l, l, d, seed)], -1)
    if case == "odd":
        wide = torch.cat([torch.zeros(b, l, 1, dtype=qkv.dtype), qkv], -1)
        (qkv,) = _slices(wide.to(device), (3 * d,))
        return qkv
    return qkv.to(device)


def heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> the strided (B, H, L, dh) view."""
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(1, 2)


def dropout_rounding_model(q, k, v, do, seed, heads: int, rate: float,
                           tile: int = 64):
    """The bf16 hash-dropout kernels' arithmetic (csrc/
    flash_attention_dropout.cu `attn_dropout_fwd_mma_kernel`,
    `attn_dropout_bwd_mma_kernel`) in plain torch, at their rounding
    points, on bf16 q, k, v, dO (B, L, D) on any device: (o, dq, dk, dv),
    bf16.

    Forward, per `tile`-key tile: fp32 scores rounded once after the
    scale, the running row max, p = exp(s - max) in fp32, the denominator
    over every key, the kept p rounded to bf16 for the value product (fp32
    sums), the rescale of both; o = acc * (inv_keep / l) rounded to bf16,
    lse = max + log(l). Backward: P = exp(s - lse), dP = dO V^T in fp32,
    D' = rowsum(keep P dP) in fp32 (as JAX forms it), dS' = P (keep dP - D');
    keep P and dS' rounded to bf16 for dV = inv_keep (keep P)^T dO and
    dK = scale inv_keep dS'^T Q, dS' split into a bf16 pair hi + lo for
    dQ = scale inv_keep dS' K (a row of dS' sums to 0, and one rounding
    would let K's mean over the keys into dQ); each output rounded to bf16.
    JAX's kernels compute the same in fp32 from the bf16 inputs and round
    only the outputs."""
    def bf(x):
        return x.to(torch.bfloat16).float()

    b, l, d = q.shape
    dh = d // heads
    scale, inv_keep = 1.0 / math.sqrt(dh), 1.0 / (1.0 - rate)
    seed = fa._seed_tensor(seed, q.device)
    bidx = torch.arange(b, device=q.device)
    outs = [torch.empty(b, l, d, device=q.device) for _ in range(4)]
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh, doh = (t[..., cols].float() for t in (q, k, v, do))
        s = (qh @ kh.transpose(1, 2)) * scale
        keep = fa.keep_mask(fa.bh_seed(seed, bidx, h, heads), 0, l, l,
                            fa.thresh(rate))
        m = torch.full((b, l, 1), -math.inf, device=q.device)
        den = torch.zeros(b, l, 1, device=q.device)
        acc = torch.zeros(b, l, dh, device=q.device)
        for k0 in range(0, l, tile):
            st = s[..., k0:k0 + tile]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            den = den * alpha + p.sum(-1, keepdim=True)
            pk = bf(torch.where(keep[..., k0:k0 + tile], p, 0.0))
            acc = acc * alpha + pk @ vh[:, k0:k0 + tile]
            m = m_new
        o = bf(acc * (inv_keep / den))
        p = torch.exp(s - (m + torch.log(den)))
        dp = doh @ vh.transpose(1, 2)
        dpk = torch.where(keep, dp, 0.0)
        ds = p * (dpk - (p * dpk).sum(-1, keepdim=True))
        hi = bf(ds)
        pk = bf(torch.where(keep, p, 0.0))
        outs[0][..., cols] = o
        outs[1][..., cols] = scale * inv_keep * ((hi + bf(ds - hi)) @ kh)
        outs[2][..., cols] = scale * inv_keep * (hi.transpose(1, 2) @ qh)
        outs[3][..., cols] = inv_keep * (pk.transpose(1, 2) @ doh)
    return tuple(t.to(torch.bfloat16) for t in outs)
