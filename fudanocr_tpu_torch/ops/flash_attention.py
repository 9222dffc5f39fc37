"""Attention kernels' wrappers and plain twins: self-attention with hash
dropout off the fused [q|k|v] buffer (B4) and off separate q, k, v buffers
(B11; Hopper kernels, forward and backward), unmasked (B, H, L, dh)
attention `flash_mha` (Hopper kernel forward, plain backward), and the
unmasked packed routes B3 and B10 (at the end of this module).

Port of the dropout part of fudanocr_tpu/ops/flash_attention.py
(`flash_mha_qkv_packed_dropout`, `flash_mha_packed_dropout` and their hash
helpers). For (B, L, 3D) qkv, or q, k, v of (B, L, D) each, with H heads
of width dh = D / H, per image and head:

    s    = q k^T / sqrt(dh)                        (float32)
    p    = exp(s - rowmax(s)),  denom = rowsum(p)
    keep = fmix((q_idx * L + k_idx) ^ bh_seed(seed, b, h)) < thresh(rate)
    o    = (keep * p) v * (1 / (1 - rate)) / denom

so dropout acts on the normalised probabilities (torch `F.dropout` on the
attention weights), and the keep decision is a murmur3 counter hash of
(seed, image, head, q, k). The hash helpers below are the JAX package's,
bit for bit, in int64 torch arithmetic (uint32 wraparound by masking), so
the port's masks equal `fudanocr_tpu.ops.flash_attention.
dropout_keep_oracle` exactly.

`flash_mha_qkv_packed_dropout` runs the plain version
(`flash_mha_qkv_packed_dropout_reference`, differentiable by autograd) on
CPU tensors. On CUDA tensors it runs `_QKVDropoutAttention`, whose forward
launches the kernel of csrc/flash_attention_dropout.cu through
`qkv_dropout_fwd` and whose backward launches the backward kernel through
`qkv_dropout_bwd`; it raises on what they do not take and never falls
back. The Function's context saves qkv and the seed, as the JAX VJP does,
plus the forward's output o and its per-row log-sum-exp (B*H*L float32):
the fp32 backward forms D_i = dO_i . o_i from them (the bf16 one forms
JAX's rowsum(keep dP P) in a pass of its own: o's bf16 rounding would
decide dS at a peaked softmax), and o is the tensor the out-projection
keeps alive for its own backward anyway.

The seed is a uint32 value held in a 0-d int64 tensor on the device (an
int is accepted too), so drawing it from a device generator needs no
host synchronisation.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
KERNEL_HEAD_WIDTH = 32   # head width the kernels are built for
KERNEL_ROW_TILE = 128    # L must be a multiple of it

Seed = Union[int, torch.Tensor]


def flash_packed_supported(lq: int, lk: int, d: int, heads: int) -> bool:
    """The JAX package's gate for the packed-qkv attention route
    (fudanocr_tpu/ops/flash_attention.py:190)."""
    return (lq == lk and 512 <= lq <= 2048 and lq % 256 == 0
            and d % heads == 0 and d <= 512 and (d // heads) % 8 == 0)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32): split so no product
    exceeds 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 (`_fmix`, flash_attention.py:256) on int64 values in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def bh_seed(seed: torch.Tensor, b: torch.Tensor, h: int,
            heads: int) -> torch.Tensor:
    """Per-(image, head) seed (`_bh_seed`, flash_attention.py:266)."""
    bh = (b * heads + h) & MASK32
    return fmix(seed ^ _mul32(bh, 0x9E3779B9))


def keep_mask(seed_bh: torch.Tensor, row0: int, rows: int, cols: int,
              thresh_: int) -> torch.Tensor:
    """(..., rows, cols) keep mask (`_keep_mask`, flash_attention.py:275):
    fmix((row * cols + col) ^ seed_bh) < thresh, with `seed_bh` of shape
    (...) broadcast over the last two axes."""
    dev = seed_bh.device
    r = torch.arange(row0, row0 + rows, device=dev, dtype=torch.int64)
    c = torch.arange(cols, device=dev, dtype=torch.int64)
    ctr = (r[:, None] * cols + c[None, :]) & MASK32
    return fmix(ctr ^ seed_bh[..., None, None]) < thresh_


def thresh(rate: float) -> int:
    """uint32 keep threshold (`_thresh`, flash_attention.py:286), rounded
    on the host with Python's `round` as the JAX package does."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _seed_tensor(seed: Seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype.is_floating_point:
            raise ValueError(f"seed must be one integer, got "
                             f"{tuple(seed.shape)} {seed.dtype}")
        return seed.reshape(()).to(device=device, dtype=torch.int64)
    if not 0 <= int(seed) <= MASK32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def _check_offset(offset: int) -> int:
    if not 0 <= int(offset) <= MASK32:
        raise ValueError(f"batch offset must be a uint32, got {offset}")
    return int(offset)


def dropout_keep_oracle(b: int, heads: int, l: int, seed: Seed,
                        rate: float, device="cpu",
                        offset: int = 0) -> torch.Tensor:
    """(B, H, L, L) bool keep mask of the whole call, the counterpart of
    the JAX package's `dropout_keep_oracle` (flash_attention.py:603),
    computed with torch ops on `device`; images are keyed on their global
    index offset + b (`offset`: a data-parallel rank's first row)."""
    seed = _seed_tensor(seed, device)
    offset = _check_offset(offset)
    bidx = torch.arange(offset, offset + b, dtype=torch.int64, device=device)
    return torch.stack([keep_mask(bh_seed(seed, bidx, h, heads), 0, l, l,
                                  thresh(rate)) for h in range(heads)], 1)


def flash_mha_qkv_packed_dropout_reference(qkv: torch.Tensor, seed: Seed,
                                           heads: int, rate: float,
                                           offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version, (B, L, 3D) -> (B, L, D) at qkv's dtype:
    `flash_mha_packed_dropout_reference` on qkv's column slices."""
    d = qkv.shape[-1] // 3
    return flash_mha_packed_dropout_reference(
        qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], seed, heads, rate,
        offset)


def flash_mha_packed_dropout_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, seed: Seed,
                                       heads: int, rate: float,
                                       offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of B11, q, k, v (B, L, D) -> (B, L, D) at
    q's dtype; image b's mask is keyed on offset + b (the kernels' b0).

    Same math and rounding points as the JAX kernels: fp32 scores and
    softmax, probabilities rounded to the input dtype for the value
    product with fp32 accumulation. One head at a time bounds the
    (B, L, L) temporaries; gradients come from autograd (the row max is
    detached, which is exact: the output does not depend on the shift).
    The gradient is that of the fp32 probabilities, as JAX's backward
    kernel forms it: autograd through the rounding would round dP to the
    input dtype and take D = rowsum(P dP) from the rounded P, and at a
    peaked softmax dS = P (dP - D) then cancels to ~1e-2 from JAX's."""
    b, l, d = q.shape
    dh = d // heads
    dt = q.dtype
    scale = 1.0 / math.sqrt(dh)
    inv_keep = 1.0 / (1.0 - rate)
    seed = _seed_tensor(seed, q.device)
    offset = _check_offset(offset)
    bidx = torch.arange(offset, offset + b, dtype=torch.int64,
                        device=q.device)
    outs = []
    for h in range(heads):
        qh, kh, vh = (t[..., h * dh:(h + 1) * dh].float() for t in (q, k, v))
        s = (qh @ kh.transpose(1, 2)) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True).detach())
        denom = p.sum(-1, keepdim=True)
        keep = keep_mask(bh_seed(seed, bidx, h, heads), 0, l, l,
                         thresh(rate))
        p = torch.where(keep, p, torch.zeros((), device=p.device))
        o = (p @ vh) * (inv_keep / denom)
        if dt != torch.float32:   # the value of p rounded to dt
            o = o + ((p.to(dt).float() @ vh) * (inv_keep / denom)
                     - o).detach()
        outs.append(o.to(dt))
    return torch.cat(outs, dim=-1)


def _columns(qkv: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The q, k, v column slices of a (B, L, 3D) buffer (views)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv dropout attention takes a (B, L, 3D) qkv, got "
                         f"{tuple(qkv.shape)}")
    d = qkv.shape[-1] // 3
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


def _check_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int, rate: float) -> Tuple[int, ...]:
    """Raise on q, k, v the dropout kernels do not take; (B, L, D)."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.float32,
                                                            torch.bfloat16):
        raise TypeError(f"dropout attention takes float32 or bfloat16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape \
            or not q.device == k.device == v.device:
        raise ValueError(f"dropout attention takes q, k, v of one (B, L, D) "
                         f"shape on one device, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, l, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1 or (b > 1 and t.stride(0) != l * t.stride(1)):
            raise ValueError(f"dropout attention: {name} needs unit feature "
                             f"stride and its images one after another, got "
                             f"strides {t.stride()}")
    if heads < 1 or d % heads or d // heads != KERNEL_HEAD_WIDTH:
        raise ValueError(f"the dropout attention kernels need head width "
                         f"{KERNEL_HEAD_WIDTH}, got D={d} over {heads} heads")
    if l < KERNEL_ROW_TILE or l % KERNEL_ROW_TILE or not 1 <= b <= 65535:
        raise ValueError(f"the dropout attention kernels need L a multiple "
                         f"of {KERNEL_ROW_TILE}, got {tuple(q.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return b, l, d


def _dropout_fwd(q, k, v, seed, heads: int, rate: float, counter,
                 offset: int = 0):
    """Check, count on `counter` and launch the forward kernel on q, k, v
    read in place at their row strides, image b keyed on offset + b:
    (o (B, L, D), lse (B, H, L) fp32)."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    b, l, d = _check_dropout(q, k, v, heads, rate)
    seed = _seed_tensor(seed, q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, heads, l), dtype=torch.float32,
                          device=q.device)
        counter.launches += 1
        check(lib.attn_dropout_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seed.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, l, heads, d // heads,
            q.stride(1), k.stride(1), v.stride(1),
            1.0 / math.sqrt(d // heads), 1.0 / (1.0 - rate), thresh(rate),
            _check_offset(offset), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "attn_dropout_fwd")
    return out, lse


def _dropout_bwd(q, k, v, out, dout, lse, seed, grads, heads: int,
                 rate: float, counter, offset: int = 0) -> None:
    """Check, count on `counter` and launch the backward kernel, writing
    dq, dk, dv into `grads` (three (B, L, D) tensors or views with unit
    feature stride)."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    b, l, d = _check_dropout(q, k, v, heads, rate)
    for name, t, shape, dtype in (("out", out, (b, l, d), q.dtype),
                                  ("dout", dout, (b, l, d), q.dtype),
                                  ("lse", lse, (b, heads, l), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"dropout attention backward: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} does "
                             f"not fit q {tuple(q.shape)} {q.dtype}")
    seed = _seed_tensor(seed, q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        # the kernels' row terms (bf16: D' and lse in base 2; fp32: D)
        work = torch.empty((2, b, heads, l), dtype=torch.float32,
                           device=q.device)
        counter.launches += 1
        check(lib.attn_dropout_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), seed.data_ptr(),
            *(g.data_ptr() for g in grads), work.data_ptr(), b, l, heads,
            d // heads,
            q.stride(1), k.stride(1), v.stride(1),
            *(g.stride(1) for g in grads), 1.0 / math.sqrt(d // heads),
            1.0 / (1.0 - rate), thresh(rate), _check_offset(offset),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "attn_dropout_bwd")


def qkv_dropout_fwd(qkv: torch.Tensor, seed: torch.Tensor, heads: int,
                    rate: float,
                    offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on qkv's column slices: (o (B, L, D), lse
    (B, H, L) fp32). `qkv_dropout_fwd.launches` counts launches."""
    return _dropout_fwd(*_columns(qkv), seed, heads, rate, qkv_dropout_fwd,
                        offset)


def qkv_dropout_bwd(qkv: torch.Tensor, out: torch.Tensor,
                    dout: torch.Tensor, lse: torch.Tensor,
                    seed: torch.Tensor, heads: int, rate: float,
                    offset: int = 0) -> torch.Tensor:
    """Launch the backward kernel: dqkv (B, L, 3D) at qkv's dtype, written
    through its column slices. `qkv_dropout_bwd.launches` counts
    launches."""
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    _dropout_bwd(*_columns(qkv), out, dout, lse, seed, _columns(dqkv), heads,
                 rate, qkv_dropout_bwd, offset)
    return dqkv


qkv_dropout_fwd.launches = 0
qkv_dropout_bwd.launches = 0


def dropout_keep_mask_cuda(seed: Seed, b: int, heads: int, l: int,
                           rate: float, device,
                           offset: int = 0) -> torch.Tensor:
    """(B, H, L, L) bool keep mask of images offset .. offset + B - 1,
    computed on the card by the same __device__ hash the kernels use (for
    tests; not counted as a launch of either kernel)."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    seed = _seed_tensor(seed, device)
    lib = load_library()
    with torch.cuda.device(seed.device):
        mask = torch.empty((b, heads, l, l), dtype=torch.uint8,
                           device=seed.device)
        check(lib.attn_dropout_keep(
            seed.data_ptr(), mask.data_ptr(), b, heads, l, thresh(rate),
            _check_offset(offset), torch.cuda.current_stream().cuda_stream),
            "attn_dropout_keep")
    return mask.bool()


class _QKVDropoutAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, seed, heads, rate, offset):
        out, lse = qkv_dropout_fwd(qkv, seed, heads, rate, offset)
        ctx.heads, ctx.rate, ctx.offset = heads, rate, offset
        ctx.save_for_backward(qkv, seed, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, seed, out, lse = ctx.saved_tensors
        dqkv = qkv_dropout_bwd(qkv, out, dout.contiguous(), lse, seed,
                               ctx.heads, ctx.rate, ctx.offset)
        return dqkv, None, None, None, None


def flash_mha_qkv_packed_dropout(qkv: torch.Tensor, seed: Seed, heads: int,
                                 rate: float,
                                 offset: int = 0) -> torch.Tensor:
    """Dropout attention over the fused [q|k|v] (B, L, 3D) buffer ->
    (B, L, D), differentiable in qkv; the gradient comes back as one
    (B, L, 3D) buffer. Image b's mask is keyed on offset + b: a
    data-parallel rank passes the global index of its first row, so its
    masks are those of its rows in one process's call on the global batch.

    CPU tensors run the plain version. CUDA tensors run the kernels (built
    at first use, see ops/_build.py) and raise on what they do not take:
    dtype other than float32/bfloat16, a feature stride other than 1 or
    images not one after another, a head width other than 32, or L not a
    multiple of 128."""
    if qkv.device.type == "cpu":
        return flash_mha_qkv_packed_dropout_reference(qkv, seed, heads, rate,
                                                      offset)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_mha_qkv_packed_dropout: no kernel for "
                         f"{qkv.device}")
    return _QKVDropoutAttention.apply(qkv, _seed_tensor(seed, qkv.device),
                                      heads, rate, _check_offset(offset))


# -- dropout attention off separate q, k, v buffers (B11) --------------------
#
# The port of `flash_mha_packed_dropout` (flash_attention.py:575-600, Pallas
# `_packed_dropout_fwd` :373 and `_packed_dropout_bwd` :401): the same
# function as B4 with q, k and v in buffers of their own. It runs B4's two
# kernels, which take each operand's base pointer and row stride, and its
# backward returns dq, dk and dv. No path of the system reaches it, as in
# JAX.


def packed_dropout_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seed: torch.Tensor, heads: int, rate: float,
                       offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on separate q, k, v: (o (B, L, D), lse
    (B, H, L) fp32). `packed_dropout_fwd.launches` counts launches."""
    return _dropout_fwd(q, k, v, seed, heads, rate, packed_dropout_fwd,
                        offset)


def packed_dropout_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor,
                       lse: torch.Tensor, seed: torch.Tensor, heads: int,
                       rate: float, offset: int = 0) -> Tuple[torch.Tensor,
                                                              ...]:
    """Launch the backward kernel: (dq, dk, dv), contiguous, at q's dtype.
    `packed_dropout_bwd.launches` counts launches."""
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _dropout_bwd(q, k, v, out, dout, lse, seed, grads, heads, rate,
                 packed_dropout_bwd, offset)
    return grads


packed_dropout_fwd.launches = 0
packed_dropout_bwd.launches = 0


class _PackedDropoutAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, seed, heads, rate, offset):
        out, lse = packed_dropout_fwd(q, k, v, seed, heads, rate, offset)
        ctx.heads, ctx.rate, ctx.offset = heads, rate, offset
        ctx.save_for_backward(q, k, v, seed, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seed, out, lse = ctx.saved_tensors
        dq, dk, dv = packed_dropout_bwd(q, k, v, out, dout.contiguous(), lse,
                                        seed, ctx.heads, ctx.rate, ctx.offset)
        return dq, dk, dv, None, None, None, None


def flash_mha_packed_dropout(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, seed: Seed, heads: int,
                             rate: float, offset: int = 0) -> torch.Tensor:
    """Dropout attention over separate (B, L, D) q, k, v -> (B, L, D),
    differentiable in q, k and v (the train-mode counterpart of
    `flash_mha_packed`); image b's mask is keyed on offset + b, as in
    `flash_mha_qkv_packed_dropout`.

    CPU tensors run the plain version. CUDA tensors run the kernels (built
    at first use, see ops/_build.py) and raise on what they do not take: a
    dtype other than float32/bfloat16, shapes that differ, a feature
    stride other than 1, a head width other than 32, or L not a multiple
    of 128."""
    if q.device.type == "cpu":
        return flash_mha_packed_dropout_reference(q, k, v, seed, heads, rate,
                                                  offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_packed_dropout: no kernel for "
                         f"{q.device}")
    return _PackedDropoutAttention.apply(q, k, v,
                                         _seed_tensor(seed, q.device), heads,
                                         rate, _check_offset(offset))


# -- unmasked attention (CascadeMiT) ----------------------------------------
#
# `flash_mha` over (B, H, L, dh) operands: the port of the JAX package's
# `flash_mha` (flash_attention.py:620), whose two Pallas variants (`_mha_full`
# :119 for Lq, Lk <= 1024 and dh <= 64, the online-softmax `_flash_mha_impl`
# :653 otherwise) compute one function. On CUDA tensors it runs the strided
# kernel of csrc/unmasked_attention.cu, which also serves the packed layout
# of ops/region_attention.py `packed_flash_mha`. Its gradient is the JAX
# VJP's plain recompute (`_flash_vjp_bwd`, plain XLA, :634-646), in plain
# PyTorch: the JAX package has no backward kernel for it.

UNMASKED_HEAD_WIDTHS = (32, 64)   # head widths the kernel is built for
UNMASKED_ROW_TILE = 128           # Lq must be a multiple of it
UNMASKED_KEY_TILE = 64            # Lkv must be a multiple of it


def flash_attention_supported(q_shape) -> bool:
    """The JAX package's gate for the `use_flash` attention route of
    nn/attention.py (fudanocr_tpu/ops/flash_attention.py:38-43): q of shape
    (B, H, L, dh) with L >= 512, L % 256 == 0 and dh in (32, 64, 128,
    256). The port's route also needs the kernel's head widths
    (`UNMASKED_HEAD_WIDTHS`)."""
    if len(q_shape) != 4:
        return False
    _, _, l, d = q_shape
    return l >= 512 and l % 256 == 0 and d in (32, 64, 128, 256)


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: q (B, H, Lq, dh), k/v (B, H, Lkv, dh) ->
    softmax(q k^T / sqrt(dh)) v, (B, H, Lq, dh) at q's dtype.

    The JAX kernels' rounding points: fp32 scores, row max subtracted, the
    unnormalised probabilities rounded to v's dtype for the value product
    with fp32 accumulation, divided by the fp32 row sum at the end. The
    (B, H, Lq, Lkv) scores are materialised once and updated in place."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s.mul_(1.0 / math.sqrt(q.shape[-1]))
    s.sub_(s.detach().amax(-1, keepdim=True)).exp_()
    denom = s.sum(-1, keepdim=True)
    o = torch.matmul(s.to(v.dtype).float(), v.float()) / denom
    return o.to(q.dtype)


def check_unmasked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   what: str) -> None:
    """Raise on operands the unmasked-attention kernel does not take (the
    layout-independent part; each wrapper checks its shapes)."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.float32,
                                                            torch.bfloat16):
        raise TypeError(f"{what} takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device or q.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what} needs unit feature strides, got "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")


def check_unmasked_shape(b: int, heads: int, lq: int, lk: int, dh: int,
                         what: str) -> None:
    if dh not in UNMASKED_HEAD_WIDTHS:
        raise ValueError(f"{what}: the kernel takes head widths "
                         f"{UNMASKED_HEAD_WIDTHS}, got {dh}")
    if (lq < UNMASKED_ROW_TILE or lq % UNMASKED_ROW_TILE
            or lk < UNMASKED_KEY_TILE or lk % UNMASKED_KEY_TILE):
        raise ValueError(f"{what}: the kernel needs Lq a multiple of "
                         f"{UNMASKED_ROW_TILE} and Lkv of {UNMASKED_KEY_TILE},"
                         f" got Lq={lq}, Lkv={lk}")
    if not (1 <= b <= 65535 and 1 <= heads <= 65535):
        raise ValueError(f"{what}: batch {b} or heads {heads} out of range")


def unmasked_bhld_fwd(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on (B, H, L, dh) operands of any batch, head and
    row strides (e.g. the (B, H, L, dh) view of a (B, L, H*dh) projection).
    The output has q's stride order. `unmasked_bhld_fwd.launches` counts
    launches."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    what = "flash_mha"
    check_unmasked(q, k, v, what)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what} takes q (B, H, Lq, dh) and k, v "
                         f"(B, H, Lkv, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    check_unmasked_shape(b, h, lq, lk, dh, what)
    lib = load_library()
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        unmasked_bhld_fwd.launches += 1
        check(lib.attn_unmasked_bhld_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, lq,
            lk, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], 1.0 / math.sqrt(dh),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "attn_unmasked_bhld_fwd")
    return o


unmasked_bhld_fwd.launches = 0


def flash_mha_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """The gradient of `flash_mha` as the JAX VJP computes it
    (`_flash_vjp_bwd`, flash_attention.py:634-646): the scores recomputed
    at q's dtype then widened to fp32, softmax, dv = p^T dO,
    dp = dO v^T, ds = p (dp - rowsum(dp p)), dq = ds k * scale,
    dk = ds^T q * scale, each at its operand's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() * scale,
                      -1)
    do32 = do.float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashMHA(torch.autograd.Function):
    """The kernel's forward; the plain recompute as the backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return unmasked_bhld_fwd(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return flash_mha_bwd_reference(*ctx.saved_tensors, do)


def flash_mha(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Unmasked softmax(q k^T / sqrt(dh)) v over (B, H, L, dh) operands,
    differentiable in q, k and v.

    CPU tensors run the plain version. CUDA tensors run the kernel (built at
    first use, see ops/_build.py), with the plain recompute as its
    backward, and raise on what it does not take: a dtype other than
    float32/bfloat16, a head width other than 32 or 64, Lq not a multiple
    of 128 or Lkv of 64, or a feature stride other than 1."""
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashMHA.apply(q, k, v)
    return unmasked_bhld_fwd(q, k, v)


# -- self-attention off the fused [q|k|v] buffer, no dropout (B3) -----------
#
# The port of the JAX package's `flash_mha_qkv_packed` (flash_attention.py:
# 220, Pallas `_qkv_kernel` :195-216), the eval route of a `use_flash`
# module (TBSRN's enhancer run unfused). On CUDA tensors it launches the
# strided kernel of csrc/unmasked_attention.cu (`unmasked_packed_fwd`, the
# B7 wrapper) on the three column slices of qkv: views at row stride 3D, no
# copy. Like B7 it is bound by its operations (4 L^2 dh flops per image and
# head against 4 L dh elements moved) and keeps the L x L scores on chip;
# with a gradient to take it runs B7's training forward and backward
# kernels (`ops/region_attention.packed_flash_mha`).


def flash_mha_packed_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int) -> torch.Tensor:
    """The plain PyTorch version of B10, q (B, Lq, D) and k, v (B, Lkv, D)
    -> (B, Lq, D) at q's dtype, at the rounding points of the JAX
    `_packed_kernel` (`flash_mha_reference` on the (B, H, L, dh) views).
    Autograd differentiates it."""
    b, lq, d = q.shape
    q, k, v = (t.unflatten(-1, (heads, d // heads)).transpose(1, 2)
               for t in (q, k, v))
    return flash_mha_reference(q, k, v).transpose(1, 2).reshape(b, lq, d)


def flash_mha_qkv_packed_reference(qkv: torch.Tensor,
                                   heads: int) -> torch.Tensor:
    """The plain PyTorch version, (B, L, 3D) -> (B, L, D) at qkv's dtype,
    at the rounding points of the JAX `_qkv_kernel`: fp32 scores times
    1/sqrt(dh), the row max subtracted, exp, the unnormalised
    probabilities rounded to v's dtype for the value product with fp32
    accumulation, divided by the fp32 row sum (`flash_mha_packed_reference`
    on qkv's column slices)."""
    d = qkv.shape[-1] // 3
    return flash_mha_packed_reference(qkv[..., :d], qkv[..., d:2 * d],
                                      qkv[..., 2 * d:], heads)


def flash_mha_qkv_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Self-attention over the fused [q|k|v] (B, L, 3D) projection ->
    (B, L, D), differentiable in qkv.

    CPU tensors run the plain version. CUDA tensors run the unmasked
    attention kernel on column slices of qkv and raise on what it does
    not take: a dtype other than float32/bfloat16, a head width other
    than 32 or 64, L not a multiple of 128, or a feature stride other
    than 1. `flash_mha_qkv_packed.launches` counts calls that launched
    the kernel (each also counts as one `unmasked_packed_fwd` launch)."""
    if qkv.device.type == "cpu":
        return flash_mha_qkv_packed_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_mha_qkv_packed: no kernel for {qkv.device}")
    from fudanocr_tpu_torch.ops.region_attention import packed_flash_mha

    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"flash_mha_qkv_packed takes a (B, L, 3D) qkv, got "
                         f"{tuple(qkv.shape)}")
    d = qkv.shape[-1] // 3
    out = packed_flash_mha(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                           heads)
    flash_mha_qkv_packed.launches += 1
    return out


flash_mha_qkv_packed.launches = 0


# -- unmasked attention off separate q, k, v buffers (B10) -------------------
#
# The port of `flash_mha_packed` (flash_attention.py:164, Pallas
# `_packed_kernel`): B7's forward kernel (`ops/region_attention.
# packed_flash_mha`) on q, k and v read in place at their own row strides.
# No path of the system reaches it, as in JAX; its gate is
# `flash_packed_supported`.


def flash_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """Unmasked multi-head attention over packed q (B, Lq, D) and k, v
    (B, Lkv, D) -> (B, Lq, D), differentiable in q, k and v.

    CPU tensors run the plain version. CUDA tensors run B7's kernels and
    raise on what they do not take (see `packed_flash_mha`).
    `flash_mha_packed.launches` counts calls that launched the kernel (each
    also counts as one `unmasked_packed_fwd` launch)."""
    if q.device.type == "cpu":
        return flash_mha_packed_reference(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_packed: no kernel for {q.device}")
    from fudanocr_tpu_torch.ops.region_attention import packed_flash_mha

    out = packed_flash_mha(q, k, v, heads)
    flash_mha_packed.launches += 1
    return out


flash_mha_packed.launches = 0
