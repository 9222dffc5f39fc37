"""Operands for the edge cases of the tensor-core attention kernels
(fudanocr_tpu_torch/csrc/unmasked_attention.cu: the bf16 `attn_fwd_mma_kernel`
and the fp32 split-TF32 kernels; the dropout kernels of
csrc/flash_attention_dropout.cu), shared by the `cuda` tests of
tests/test_torch_seg_attention.py, test_torch_seg_attention_bwd.py,
test_torch_qkv_attention.py, test_torch_packed_attention.py and
test_torch_flash_attention.py; `dropout_rounding_model`, the bf16 dropout
kernels' arithmetic in plain torch; `bf16_attention_model`, the bf16
training and MASKED seg attention kernels' arithmetic (tests/
test_torch_seg_bf16_rounding.py); and `tf32x3_attention_model`, the fp32
kernels' arithmetic (tests/test_torch_tf32x3_rounding.py). Each case is made
on the CPU from a seed, then moved to the card in bf16 (`CASES`) or fp32
(`FP32_CASES`):

* "plain": standard normals;
* "odd": the same values as column slices of wider buffers at odd element
  offsets and odd row strides, which rule out the kernels' 16-byte copies
  (their 2-byte (bf16) or 4-byte (fp32) copies run);
* "rising": positive q and keys whose mean grows with the key index, so the
  running row max rises tile after tile and every row's max lies in the
  last key tile (the online softmax's rescale path);
* "x16": q scaled by 16, scores of magnitude up to ~60 (large |s|);
* "peaked": q scaled by 5.6, scores of magnitude up to ~30, the peaked
  softmax the fp32 bar still holds at (fp32's own rounding of the scores
  moves o by about half of 1e-5 there);
* "large": v uniform in [-8, 8], outputs of magnitude up to ~8.
"""

import math

import torch

from fudanocr_tpu_torch.ops import flash_attention as fa

CASES = ("plain", "odd", "rising", "x16")
FP32_CASES = ("plain", "odd", "rising", "peaked", "large")


def _values(case: str, b: int, lq: int, lkv: int, d: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, d, generator=gen) for n in (lq, lkv, lkv))
    if case == "rising":
        q = q.abs() + 0.5
        k = 0.3 * k + torch.linspace(0.0, 2.0, lkv)[None, :, None]
    elif case == "x16":
        q = 16 * q
    elif case == "peaked":
        q = 5.6 * q
    elif case == "large":
        v = 16 * torch.rand(v.shape, generator=gen) - 8
    return q, k, v


def _slices(buf: torch.Tensor, widths, offset: int = 1):
    """Column slices of `buf` of the given widths, the first at `offset`."""
    out = []
    for w in widths:
        out.append(buf[..., offset:offset + w])
        offset += w
    return out


def edge_qkv(case: str, b: int, lq: int, lkv: int, d: int, device,
             seed: int = 0, dtype=torch.bfloat16):
    """q (B, Lq, D) and k, v (B, Lkv, D) of `dtype` on `device`."""
    q, k, v = (t.to(dtype) for t in _values(case, b, lq, lkv, d, seed))
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


# -- the bf16 seg attention kernels' arithmetic -------------------------------

def bf16_attention_model(q, k, v, heads: int, rq=None, rkv=None, do=None,
                         o32_from: str = "pair", dq_split: bool = True,
                         tile: int = 64):
    """The bf16 training kernels of csrc/unmasked_attention.cu
    (`attn_fwd_mma_kernel` with STATS, `attn_bwd_dq_mma_kernel`,
    `attn_bwd_dkv_mma_kernel`) in plain torch, at their rounding points, on
    bf16 packed q (B, Lq, D), k, v (B, Lkv, D), ids rq (B, Lq), rkv (B, Lkv)
    or None (unmasked), dO (B, Lq, D) or None (forward only). Returns
    (o bf16, o32, m, inv) and, with dO, also (dq, dk, dv) in bf16.

    The products of bf16 operands are exact in fp32 and summed in fp32 (the
    tensor cores' order is not modelled: it moves sums by fp32 ulps; nor is
    the unmasked kernel's exponent, one FMA with scale * log2(e) folded in,
    an ulp of its argument from s - m).
    Forward per `tile` keys: s = fp32(q k^T) * scale, rounded, plus -1e10
    where the ids are equal, rounded again; the running max from -inf,
    alpha = exp(m_old - m_new), p = exp(s - m_new), l = l * alpha + rowsum
    p; p as a bf16 pair hi = bf16(p), lo = bf16(p - hi), acc_hi and acc_lo
    rescaled by alpha and summed with hi V and lo V. o = bf16(acc_hi / l),
    JAX's `p.astype(v.dtype)`; o32 = (acc_hi + acc_lo) / l, the fp32
    probabilities' product that JAX's backward forms D from
    (`o32_from`="hi": acc_hi / l, one rounding of p; the rejected
    simplification). Statistics m and inv = 1 / l per (image, head, row).
    Backward: D = rowsum(dO o32) in fp32, p = exp(s - m) * inv, dP = dO V^T,
    dS = p (dP - D); dV = bf16(P)^T dO, dK = scale bf16(dS)^T Q, and
    dQ = scale (hi + lo) K with dS as a bf16 pair (`dq_split`=False: one
    rounding, the rejected simplification: a row of dS sums to 0, and one
    rounding lets K's mean into dQ)."""
    from fudanocr_tpu_torch.ops.region_attention import NEG

    def bf(x):
        return x.to(torch.bfloat16).float()

    b, lq, d = q.shape
    lkv = k.shape[1]
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)
    neg = None
    if rq is not None:
        neg = torch.where(rq.float()[:, :, None] == rkv.float()[:, None, :],
                          torch.tensor(NEG), torch.tensor(0.0)).to(q.device)
    o = torch.empty(b, lq, d, device=q.device)
    o32 = torch.empty_like(o)
    ms = torch.empty(b, heads, lq, device=q.device)
    invs = torch.empty_like(ms)
    grads = [torch.empty(b, n, d, device=q.device) for n in (lq, lkv, lkv)]
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh = (t[..., cols].float() for t in (q, k, v))
        s = (qh @ kh.transpose(1, 2)) * scale
        if neg is not None:
            s = s + neg
        m = torch.full((b, lq, 1), -math.inf, device=q.device)
        l = torch.zeros(b, lq, 1, device=q.device)
        acc_hi = torch.zeros(b, lq, dh, device=q.device)
        acc_lo = torch.zeros_like(acc_hi)
        for k0 in range(0, lkv, tile):
            st = s[..., k0:k0 + tile]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = bf(p)
            acc_hi = acc_hi * alpha + hi @ vh[:, k0:k0 + tile]
            acc_lo = acc_lo * alpha + bf(p - hi) @ vh[:, k0:k0 + tile]
            m = m_new
        inv = 1.0 / l
        o[..., cols] = bf(acc_hi / l)
        o32[..., cols] = (acc_hi + acc_lo) / l if o32_from == "pair" \
            else acc_hi / l
        ms[:, h], invs[:, h] = m[..., 0], inv[..., 0]
        if do is None:
            continue
        doh = do[..., cols].float()
        dsum = (doh * o32[..., cols]).sum(-1, keepdim=True)
        p = torch.exp(s - m) * inv
        ds = p * (doh @ vh.transpose(1, 2) - dsum)
        hi = bf(ds)
        dq_op = hi + bf(ds - hi) if dq_split else hi
        grads[0][..., cols] = scale * (dq_op @ kh)
        grads[1][..., cols] = scale * (hi.transpose(1, 2) @ qh)
        grads[2][..., cols] = bf(p).transpose(1, 2) @ doh
    out = (o.to(torch.bfloat16), o32, ms, invs)
    if do is None:
        return out
    return out + tuple(g.to(torch.bfloat16) for g in grads)


# -- the fp32 kernels' arithmetic: split TF32 on the tensor cores ----------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest,
    ties away from zero): 0x1000 added to the int32 view, the 13 low bits
    masked off (0xFFFFE000)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero, as the tensor cores round the
    sum of an mma's products and its accumulator (scripts/
    tf32_mma_rounding.py, on an H100)."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k8 step, c + a b over 8 columns of a: the products exact,
    their sum with c rounded once, toward zero."""
    return _rz(c.double() + a.double() @ b.double())


def _mm(a: torch.Tensor, b: torch.Tensor, products: int,
        small_first: bool) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) from a zero accumulator, 8 columns of a
    per mma, in `products` TF32 products per step (3: split TF32, hi hi +
    hi lo + lo hi; 1: one TF32 product). small_first: the small products of
    every step before the large ones (S and dP = Q K^T, dO V^T); otherwise
    small, small, large per step (the products with P or dS)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    c = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32,
                    device=a.device)
    steps = range(0, a.shape[-1], 8)

    def step(c, x, y, k0):
        return _mma(c, x[..., k0:k0 + 8], y[..., k0:k0 + 8, :])

    for k0 in steps:
        if products == 3:
            c = step(step(c, al, bh, k0), ah, bl, k0)
        if products == 1 or not small_first:
            c = step(c, ah, bh, k0)
    if products == 3 and small_first:
        for k0 in steps:
            c = step(c, ah, bh, k0)
    return c


def tf32x3_attention_model(q, k, v, heads: int, rq=None, rkv=None, do=None,
                           products: int = 3, tile: int = 64):
    """The fp32 kernels of csrc/unmasked_attention.cu
    (`attn_fwd_tf32x3_kernel`, `attn_bwd_dq_tf32x3_kernel`,
    `attn_bwd_dkv_tf32x3_kernel`) in plain torch, at their rounding points,
    on fp32 packed q (B, Lq, D), k, v (B, Lkv, D), ids rq (B, Lq), rkv
    (B, Lkv) or None (unmasked), dO (B, Lq, D) or None (forward only).
    Returns o, or (o, dq, dk, dv).

    Every product is split TF32 (`products`=3: each operand x = hi + lo,
    hi = tf32(x), lo = tf32(x - hi); hi hi + hi lo + lo hi), one m16n8k8
    step of 8 columns at a time, each step's sum rounded toward zero, and
    starts from zero for each `tile` of keys (or q rows): S = Q K^T and
    dP = dO V^T small products first; P V, dS K, P^T dO, dS^T Q small,
    small, large per step. `products`=1 is the same with one TF32 product.
    Forward per key tile: s = fp32(S) * scale (+ -1e10 where the ids are
    equal), the running max from -inf, alpha = exp(m_old - m_new),
    p = exp(s - m_new), l = l * alpha + rowsum(p), acc = acc * alpha + P V
    (one fp32 rounding); o = acc * (1 / l). Backward: P = exp(s - m) *
    (1 / l) from the forward's statistics, D = rowsum(dO o) in fp32,
    dS = P (dP - D); dq = scale * (sum over key tiles of dS K), dv and dk
    the fp32 sums over q tiles of P^T dO and dS^T Q, grouped by the
    kernels' q slices (`bwd_q_chunk`) and summed over slices in order, dk
    times scale."""
    from fudanocr_tpu_torch.ops.region_attention import NEG, bwd_q_chunk

    b, lq, d = q.shape
    lkv = k.shape[1]
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)
    mm = lambda a, c, first: _mm(a, c, products, first)
    neg = None
    if rq is not None:
        neg = torch.where(rq.float()[:, :, None] == rkv.float()[:, None, :],
                          torch.tensor(NEG), torch.tensor(0.0)).to(q.device)
    outs = [torch.empty(b, n, d, device=q.device)
            for n in (lq, lq, lkv, lkv)]

    def scores(qh, kh, q0, k0, n_q, n_k):
        s = mm(qh[:, q0:q0 + n_q], kh[:, k0:k0 + n_k].transpose(1, 2),
               True) * scale
        if neg is not None:
            s = s + neg[:, q0:q0 + n_q, k0:k0 + n_k]
        return s

    chunk = bwd_q_chunk(b, heads, lq, lkv)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh = (t[..., cols].float() for t in (q, k, v))
        m = torch.full((b, lq, 1), -math.inf, device=q.device)
        l = torch.zeros(b, lq, 1, device=q.device)
        acc = torch.zeros(b, lq, dh, device=q.device)
        for k0 in range(0, lkv, tile):
            s = scores(qh, kh, 0, k0, lq, tile)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            part = mm(p, vh[:, k0:k0 + tile], False)
            acc = (acc.double() * alpha.double() + part.double()).float()
            m = m_new
        inv = 1.0 / l
        o = acc * inv
        outs[0][..., cols] = o
        if do is None:
            continue
        doh = do[..., cols].float()
        dsum = (doh * o).sum(-1, keepdim=True)
        dq = torch.zeros(b, lq, dh, device=q.device)
        for k0 in range(0, lkv, tile):
            p = torch.exp(scores(qh, kh, 0, k0, lq, tile) - m) * inv
            ds = p * (mm(doh, vh[:, k0:k0 + tile].transpose(1, 2), True)
                      - dsum)
            dq = dq + mm(ds, kh[:, k0:k0 + tile], False)
        outs[1][..., cols] = dq * scale
        dk = torch.zeros(b, lkv, dh, device=q.device)
        dv = torch.zeros_like(dk)
        for c0 in range(0, lq, chunk):
            dk_s = torch.zeros_like(dk)
            dv_s = torch.zeros_like(dv)
            for q0 in range(c0, min(lq, c0 + chunk), tile):
                rows = slice(q0, q0 + tile)
                st = scores(qh, kh, q0, 0, tile, lkv).transpose(1, 2)
                pt = torch.exp(st - m[:, rows].transpose(1, 2)) \
                    * inv[:, rows].transpose(1, 2)
                dpt = mm(vh, doh[:, rows].transpose(1, 2), True)
                dst = pt * (dpt - dsum[:, rows].transpose(1, 2))
                dv_s = dv_s + mm(pt, doh[:, rows], False)
                dk_s = dk_s + mm(dst, qh[:, rows], False)
            dk, dv = dk + dk_s, dv + dv_s
        outs[2][..., cols] = dk * scale
        outs[3][..., cols] = dv
    return outs[0] if do is None else tuple(outs)


def dropout_tf32x3_model(q, k, v, do, seed, heads: int, rate: float,
                         products: int = 3, dsum: str = "o",
                         tile: int = 64):
    """The fp32 hash-dropout kernels of csrc/
    flash_attention_dropout_tf32x3.cu (`attn_dropout_fwd_tf32x3_kernel`,
    `attn_dropout_bwd_dq_tf32x3_kernel`, `attn_dropout_bwd_dkv_tf32x3_kernel`)
    in plain torch, at their rounding points, on fp32 q, k, v, dO (B, L, D):
    (o, dq, dk, dv), fp32.

    Every product is split TF32 as in `tf32x3_attention_model` (`products`
    3 or 1, each m16n8k8 step's sum rounded toward zero, every sum started
    afresh for each `tile` of keys or q rows and added on in fp32).
    Forward per key tile: s = fp32(S) * scale, the running max from -inf,
    alpha = exp(m_old - m_new), p = exp(s - m_new), l = l * alpha +
    rowsum(p) over every key, the dropped p zeroed before the split for
    P V, acc = acc * alpha + P V; o = acc * (inv_keep / l), lse = m +
    log(l). Backward: P = exp(s - lse), dP = dO V^T, dP' = keep dP *
    inv_keep, dS = P (dP' - D), with D = rowsum(dO o) from the fp32 output
    (`dsum`="o", what the kernels take) or D' = rowsum(dP' P) (`dsum`=
    "dprime", what JAX forms); dq = scale * (sum over key tiles of dS K),
    dk = scale * (sum over q tiles of dS^T Q), dv = inv_keep * (sum over q
    tiles of (keep P)^T dO)."""
    b, l, d = q.shape
    dh = d // heads
    scale, inv_keep = 1.0 / math.sqrt(dh), 1.0 / (1.0 - rate)
    seed = fa._seed_tensor(seed, q.device)
    bidx = torch.arange(b, device=q.device)
    mm = lambda a, c, first: _mm(a, c, products, first)
    outs = [torch.empty(b, l, d, device=q.device) for _ in range(4)]
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh, doh = (t[..., cols].float() for t in (q, k, v, do))
        keep = fa.keep_mask(fa.bh_seed(seed, bidx, h, heads), 0, l, l,
                            fa.thresh(rate))
        s = mm(qh, kh.transpose(1, 2), True) * scale
        m = torch.full((b, l, 1), -math.inf, device=q.device)
        den = torch.zeros(b, l, 1, device=q.device)
        acc = torch.zeros(b, l, dh, device=q.device)
        for k0 in range(0, l, tile):
            st = s[..., k0:k0 + tile]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            den = den * alpha + p.sum(-1, keepdim=True)
            pk = torch.where(keep[..., k0:k0 + tile], p, 0.0)
            part = mm(pk, vh[:, k0:k0 + tile], False)
            acc = (acc.double() * alpha.double() + part.double()).float()
            m = m_new
        o = acc * (inv_keep / den)
        outs[0][..., cols] = o
        p = torch.exp(s - (m + torch.log(den)))
        dp = mm(doh, vh.transpose(1, 2), True)
        dpk = torch.where(keep, dp * inv_keep, 0.0)
        if dsum == "o":
            dd = (doh * o).sum(-1, keepdim=True)
        else:
            dd = (dpk * p).sum(-1, keepdim=True)
        ds = p * (dpk - dd)
        pk = torch.where(keep, p, 0.0)
        dq = torch.zeros(b, l, dh, device=q.device)
        dk = torch.zeros_like(dq)
        dv = torch.zeros_like(dq)
        for k0 in range(0, l, tile):
            dq = dq + mm(ds[..., k0:k0 + tile], kh[:, k0:k0 + tile], False)
        for q0 in range(0, l, tile):
            rows = slice(q0, q0 + tile)
            dk = dk + mm(ds[:, rows].transpose(1, 2), qh[:, rows], False)
            dv = dv + mm(pk[:, rows].transpose(1, 2), doh[:, rows], False)
        outs[1][..., cols] = dq * scale
        outs[2][..., cols] = dk * scale
        outs[3][..., cols] = dv * inv_keep
    return tuple(outs)
