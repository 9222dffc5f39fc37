"""Unmasked attention over lane-packed (B, L, H*dh) operands: Hopper kernel
(forward) + plain twin.

Port of the unmasked part of fudanocr_tpu/ops/region_attention.py:
`packed_flash_supported` (:275, the shape gate of :44-54) and
`packed_flash_mha` (:340, Pallas forward `_plain_fwd` :280). q is
(B, Lq, H*dh), k and v are (B, Lkv, H*dh), head h lives in columns
[h*dh, (h+1)*dh), and the result is (B, Lq, H*dh):

    o_h = softmax(q_h k_h^T / sqrt(dh)) v_h

`packed_flash_mha` runs the plain version on CPU tensors. On CUDA tensors
it launches the strided kernel of csrc/unmasked_attention.cu through
`unmasked_packed_fwd`, the same kernel `flash_mha` (ops/flash_attention.py)
launches for the (B, H, L, dh) layout, and raises on what it does not take;
it never falls back. Forward only: the Pallas backward `_plain_bwd` (:306)
is the segmentation training slice's, and the region-masked variant (B6) the
det-guided slice's.
"""

from __future__ import annotations

import math

import torch

from fudanocr_tpu_torch.ops.flash_attention import (check_unmasked,
                                                    check_unmasked_shape,
                                                    flash_mha_reference)


def packed_flash_supported(lq: int, lkv: int, d: int, heads: int) -> bool:
    """CascadeMiT's gate for the packed route: the device-side condition of
    the JAX package's `region_flash_supported` (region_attention.py:44-54),
    without its bound for CPU interpret mode."""
    return (lq >= 1024 and lq % 256 == 0
            and 128 <= lkv <= 2048 and lkv % 128 == 0
            and d % heads == 0 and (d // heads) % 8 == 0 and d <= 512)


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


def unmasked_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Launch the kernel on packed operands: rows with unit feature stride,
    any row stride (a column slice of a wider buffer is read in place), an
    image's rows one after another. Returns a contiguous (B, Lq, D).
    `unmasked_packed_fwd.launches` counts launches."""
    from fudanocr_tpu_torch.ops._build import check, load_library

    what = "packed_flash_mha"
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
