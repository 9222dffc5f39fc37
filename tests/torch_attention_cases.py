"""Operands for the edge cases of the bf16 tensor-core attention forward
(fudanocr_tpu_torch/csrc/unmasked_attention.cu `attn_fwd_mma_kernel`),
shared by the `cuda` tests of tests/test_torch_seg_attention.py,
test_torch_qkv_attention.py and test_torch_packed_attention.py. Each case
is made on the CPU from a seed, then moved to the card in bf16:

* "plain": standard normals;
* "odd": the same values as column slices of wider buffers at odd element
  offsets and odd row strides, which rule out the kernel's 16-byte copies
  (its 2-byte copy variant runs);
* "rising": positive q and keys whose mean grows with the key index, so the
  running row max rises tile after tile and every row's max lies in the
  last key tile (the online softmax's rescale path);
* "x16": q scaled by 16, scores of magnitude up to ~60 (large |s|).
"""

import torch

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
