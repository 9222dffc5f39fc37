"""The whole TBSRN residual block (SRB) at inference: Hopper kernels + plain
twin.

Port of fudanocr_tpu/ops/fused_srb.py. For a channels-last (B, H, W, C=64)
feature map x, per image, with inference BatchNorm folded into the convs
(`fold_bn`: W' = W * s, b' = (b - mean) * s + beta, s = gamma /
sqrt(var + eps), in fp32 outside the kernel, as JAX folds it outside its
kernel):

    r1  = T(mish(conv3x3(x, W1') + b1'))      fp32 accumulation and mish
    r   = T(conv3x3(r1, W2') + b2')
    out = T(x + enhancer(r))                  the enhancer's final projection
                                              kept fp32, added, rounded once

where T is x's dtype, SAME padding, and `enhancer` is the FeatureEnhancer
of ops/fused_enhancer.py (JAX `enhancer_body`). The one rounding point
that differs from the module path (conv, BN, mish, conv, BN, enhancer,
add) is the last: the module rounds the projection before the residual
add, the kernel after it (JAX fused_srb.py:119).

`fused_srb` launches the hand-written CUDA kernels on CUDA tensors. In
bf16, three launches: conv1 with mish (`srb_conv_mish`), conv2 with the
enhancer's qkv projection in its epilogue (`srb_conv_qkv`: r and the
(B, L, 384) qkv, qkv = T(r @ wtop + peqkv[l]) rounded once), both on
wgmma with the weights resident in shared memory and the input bands
loaded by TMA (csrc/fused_srb.cu), then csrc/fused_enhancer.cu's attention
epilogue with the block input as its residual. In fp32, four: the two
CUDA-core convolutions, the enhancer's qkv projection and its epilogue
(both in split TF32 on the tensor cores).
`fused_srb.launches` counts calls (`srb_conv_mish.launches` and
`srb_conv_qkv.launches` count their own calls; the enhancer's own counter
`fused_enhancer.launches` is not moved). CPU tensors run the plain
PyTorch versions (`fused_srb_reference`, `srb_conv_mish_reference`,
`srb_conv_qkv_reference`). Nothing falls back on a CUDA tensor: it
launches or raises. Inference only.

The bf16 kernels read their weights packed by `pack_sw128` (the K-major,
128-byte-swizzled layout of wgmma's B operand); `srb_operands` adds them
beside the (9*C, C) weights the plain versions and the fp32 kernel read,
and `unpack_sw128` is its inverse.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.ops._build import check, load_library
from fudanocr_tpu_torch.ops.fused_enhancer import (EPILOGUE_OPERANDS,
                                                   check_cuda_operands,
                                                   enhancer_reference_fp32,
                                                   fused_enhancer_supported)

# the bf16 kernels' weights, packed by `pack_sw128`, and their shapes
PACKED_OPERANDS = {"conv1_wg": (9 * 64, 64), "conv2_wg": (9 * 64, 64),
                   "wtop_wg": (384, 64)}


def fused_srb_supported(h: int, w: int, c: int, heads: int) -> bool:
    """The JAX package's gate for the whole-SRB route
    (fudanocr_tpu/ops/fused_srb.py:50-51)."""
    return fused_enhancer_supported(h * w, c + 64, heads) and c % 8 == 0


def fold_bn(weight: torch.Tensor, bias: torch.Tensor,
            bn: Dict[str, torch.Tensor],
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into the conv before it, in fp32: an OIHW
    `weight` and its bias, and `bn` holding the BN's "scale", "bias",
    "mean" and "var" -> (W' = W * s over the output channels,
    b' = (b - mean) * s + beta), s = scale / sqrt(var + eps) (JAX
    `fold_bn`, fused_srb.py:54-60)."""
    s = bn["scale"].float() * torch.rsqrt(bn["var"].float() + eps)
    return (weight.float() * s.view(-1, 1, 1, 1),
            (bias.float() - bn["mean"].float()) * s + bn["bias"].float())


def _sw128_columns(rows: int, device) -> torch.Tensor:
    """(rows, 64): the column at which row n of a packed block holds k: the
    16-byte chunk k // 8 moves to chunk (k // 8) ^ (n % 8)."""
    n = torch.arange(rows, device=device).view(-1, 1)
    k = torch.arange(64, device=device).view(1, -1)
    return ((k // 8) ^ (n % 8)) * 8 + k % 8


def pack_sw128(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) weight (K a multiple of 64) in the layout of wgmma's B
    operand with the 128-byte swizzle, as csrc/fused_srb.cu reads it from
    shared memory: (K // 64 * N, 64), block kb's row n holding w[kb*64 +
    k, n] for k < 64 (K-major, 128 bytes a row in bf16) at column
    `_sw128_columns`. A permutation: `unpack_sw128` inverts it."""
    k, n = w.shape
    if k % 64:
        raise ValueError(f"pack_sw128 needs K a multiple of 64, got {k}")
    blocks = w.reshape(k // 64, 64, n).transpose(1, 2)   # [kb, n, k]
    cols = _sw128_columns(n, w.device).expand(k // 64, n, 64)
    out = torch.empty_like(blocks).scatter_(2, cols, blocks)
    return out.reshape(-1, 64).contiguous()


def unpack_sw128(p: torch.Tensor, n: int) -> torch.Tensor:
    """The (K, N) weight that `pack_sw128` packed into `p` (K // 64 * n,
    64)."""
    blocks = p.reshape(-1, n, 64)
    cols = _sw128_columns(n, p.device).expand(blocks.shape[0], n, 64)
    return (torch.gather(blocks, 2, cols).transpose(1, 2)
            .reshape(-1, n).contiguous())


def srb_operands(conv1: Tuple[torch.Tensor, torch.Tensor],
                 bn1: Dict[str, torch.Tensor],
                 conv2: Tuple[torch.Tensor, torch.Tensor],
                 bn2: Dict[str, torch.Tensor],
                 enhancer_ops: Dict[str, torch.Tensor], dtype: torch.dtype,
                 bn_eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """The kernel operands: the enhancer's (`enhancer_operands`, built for
    the map's H*W and `dtype`) plus each conv's BN-folded weights in the
    kernel's (9*C, C) layout at `dtype` (tap (dy+1)*3 + (dx+1) in rows
    [tap*C, (tap+1)*C), from the torch OIHW weight) and its fp32 bias.
    In bf16 also the bf16 kernels' packed weights (`PACKED_OPERANDS`):
    `pack_sw128` of each conv's (9*C, C) weight and, where
    `enhancer_ops` holds it, of the enhancer's (C, 384) wtop.
    `conv1`/`conv2` are (OIHW weight, bias); `bn1`/`bn2` as `fold_bn`
    takes them."""
    ops = dict(enhancer_ops)
    for name, (w, b), bn in (("conv1", conv1, bn1), ("conv2", conv2, bn2)):
        wf, bf = fold_bn(w, b, bn, bn_eps)
        ops[f"{name}_w"] = (wf.permute(2, 3, 1, 0).reshape(-1, wf.shape[0])
                            .to(dtype).contiguous())
        ops[f"{name}_b"] = bf.contiguous()
        if dtype == torch.bfloat16:
            ops[f"{name}_wg"] = pack_sw128(ops[f"{name}_w"])
    if dtype == torch.bfloat16 and "wtop" in ops:
        ops["wtop_wg"] = pack_sw128(ops["wtop"])
    return ops


def _conv_reference(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of NHWC x with (9*C, C) kernel-layout weights at x's
    dtype; fp32 accumulation, fp32 result."""
    c = x.shape[-1]
    oihw = w.float().reshape(3, 3, c, -1).permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), oihw, b, padding=1)
    return y.permute(0, 2, 3, 1)


def srb_conv_mish_reference(x: torch.Tensor,
                            ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain version of the first launch: r1 = T(mish(conv3x3(x, W1')
    + b1')), (B, H, W, C) at x's dtype."""
    r = _conv_reference(x, ops["conv1_w"], ops["conv1_b"])
    return (r * torch.tanh(F.softplus(r))).to(x.dtype)


def srb_conv_qkv_reference(r1: torch.Tensor, ops: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the second launch: r = T(conv3x3(r1, W2') +
    b2') (B, H, W, C) and the enhancer's qkv of r, T(r @ wtop +
    peqkv[l]) (B, H*W, 384), the sum in fp32 and rounded once, as
    `enhancer_reference_fp32` computes it."""
    dt = r1.dtype
    b, h, w, c = r1.shape
    r = _conv_reference(r1, ops["conv2_w"], ops["conv2_b"]).to(dt)
    qkv = r.reshape(b, h * w, c).float() @ ops["wtop"].float() + ops["peqkv"]
    return r, qkv.to(dt)


def fused_srb_reference(x: torch.Tensor, ops: Dict[str, torch.Tensor],
                        heads: int = 4, eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version, (B, H, W, C) -> (B, H, W, C) at x's
    dtype, at the JAX kernel's rounding points. Works on any device; the
    CPU tests and TBSRN's CPU route use it."""
    dt = x.dtype
    b, h, w, c = x.shape
    r1 = srb_conv_mish_reference(x, ops)
    r = _conv_reference(r1, ops["conv2_w"], ops["conv2_b"]).to(dt)
    out = enhancer_reference_fp32(r.reshape(b, h * w, c), ops, heads, eps)
    return (x.float() + out.view(b, h, w, c)).to(dt)


def _check_map(x: torch.Tensor, heads: int = 4) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_srb takes float32 or bfloat16 features, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"fused_srb needs a contiguous, 16-byte aligned "
                         f"channels-last (B, H, W, C) map, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, h, w, c = x.shape
    if c != 64 or not fused_srb_supported(h, w, c, heads) or b > 65535:
        raise ValueError(f"fused_srb needs C = 64 and H*W in the SRB gate "
                         f"(512 <= H*W <= 2048, a multiple of 256), got "
                         f"{tuple(x.shape)}")


def _check_operands(x: torch.Tensor, ops: Dict[str, torch.Tensor],
                    names) -> None:
    c = x.shape[-1]
    for k in names:
        t = ops.get(k)
        want = (((c,), torch.float32) if k.endswith("_b") else
                (PACKED_OPERANDS[k], x.dtype) if k in PACKED_OPERANDS else
                ((9 * c, c), x.dtype))
        if (t is None or (tuple(t.shape), t.dtype) != want
                or t.device != x.device or not t.is_contiguous()):
            what = ("missing" if t is None else
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
            raise ValueError(f"fused_srb operand {k!r}: {what} does not fit "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")


def _conv_names(conv: str, x: torch.Tensor) -> tuple:
    """The operands of one conv launch at x's dtype."""
    w = f"{conv}_wg" if x.dtype == torch.bfloat16 else f"{conv}_w"
    return (w, f"{conv}_b")


def _check(x: torch.Tensor, ops: Dict[str, torch.Tensor], heads: int) -> None:
    _check_map(x, heads)
    b, h, w, c = x.shape
    check_cuda_operands(x.view(b, h * w, c), ops, heads)
    names = _conv_names("conv1", x) + _conv_names("conv2", x)
    if x.dtype == torch.bfloat16:
        names += ("wtop_wg",)
    _check_operands(x, ops, names)


def _launch_conv_mish(lib, x, ops, r1, stream) -> None:
    b, h, w, _ = x.shape
    wk, bk = _conv_names("conv1", x)
    if x.dtype == torch.bfloat16:
        check(lib.srb_conv3x3_mish_bf16(
            x.data_ptr(), ops[wk].data_ptr(), ops[bk].data_ptr(),
            r1.data_ptr(), b, h, w, stream), "srb_conv3x3_mish_bf16")
    else:
        check(lib.srb_conv3x3(x.data_ptr(), ops[wk].data_ptr(),
                              ops[bk].data_ptr(), r1.data_ptr(), b, h, w, 1,
                              stream), "srb_conv3x3")


def _launch_conv_qkv(lib, r1, ops, r, qkv, stream) -> None:
    b, h, w, _ = r1.shape
    wk, bk = _conv_names("conv2", r1)
    if r1.dtype == torch.bfloat16:
        check(lib.srb_conv3x3_qkv_bf16(
            r1.data_ptr(), ops[wk].data_ptr(), ops[bk].data_ptr(),
            ops["wtop_wg"].data_ptr(), ops["peqkv"].data_ptr(), r.data_ptr(),
            qkv.data_ptr(), b, h, w, stream), "srb_conv3x3_qkv_bf16")
        return
    check(lib.srb_conv3x3(r1.data_ptr(), ops[wk].data_ptr(),
                          ops[bk].data_ptr(), r.data_ptr(), b, h, w, 0,
                          stream), "srb_conv3x3")
    check(lib.fe_qkv_proj(r.data_ptr(), ops["wtop"].data_ptr(),
                          ops["peqkv"].data_ptr(), qkv.data_ptr(), b * h * w,
                          h * w, 0, stream), "fe_qkv_proj")


def _cuda_only(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")


def srb_conv_mish(x: torch.Tensor, ops: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """The first launch of `fused_srb` alone: r1 = T(mish(conv3x3(x, W1')
    + b1')) for a (B, H, W, 64) map that `fused_srb` takes. CPU tensors
    run `srb_conv_mish_reference`; CUDA tensors launch (bf16: the wgmma
    kernel, fp32: the CUDA-core one) or raise."""
    if x.device.type == "cpu":
        return srb_conv_mish_reference(x, ops)
    _cuda_only(x, "srb_conv_mish")
    _check_map(x)
    _check_operands(x, ops, _conv_names("conv1", x))
    lib = load_library()
    with torch.cuda.device(x.device):
        r1 = torch.empty_like(x)
        srb_conv_mish.launches += 1
        _launch_conv_mish(lib, x, ops, r1,
                          torch.cuda.current_stream().cuda_stream)
    return r1


def srb_conv_qkv(r1: torch.Tensor, ops: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second launch of `fused_srb` alone: (r, qkv) of
    `srb_conv_qkv_reference` for a (B, H, W, 64) map. CPU tensors run
    that; CUDA tensors launch (bf16: one wgmma kernel; fp32: the CUDA-core
    conv, then the enhancer's split-TF32 qkv projection) or raise."""
    if r1.device.type == "cpu":
        return srb_conv_qkv_reference(r1, ops)
    _cuda_only(r1, "srb_conv_qkv")
    _check_map(r1)
    b, h, w, c = r1.shape
    check_cuda_operands(r1.view(b, h * w, c), ops, 4)
    names = _conv_names("conv2", r1)
    _check_operands(r1, ops, names + (("wtop_wg",) if
                                      r1.dtype == torch.bfloat16 else ()))
    lib = load_library()
    with torch.cuda.device(r1.device):
        r = torch.empty_like(r1)
        qkv = torch.empty((b, h * w, 3 * ops["wout"].shape[0]),
                          dtype=r1.dtype, device=r1.device)
        srb_conv_qkv.launches += 1
        _launch_conv_qkv(lib, r1, ops, r, qkv,
                         torch.cuda.current_stream().cuda_stream)
    return r, qkv


def fused_srb(x: torch.Tensor, ops: Dict[str, torch.Tensor], heads: int = 4,
              eps: float = 1e-6) -> torch.Tensor:
    """One SRB on a channels-last (B, H, W, C) map -> the same shape.

    CPU tensors run `fused_srb_reference`. CUDA tensors launch the kernels
    (built at first use, see ops/_build.py) and raise on what they do not
    take: a dtype other than float32/bfloat16, a map that is not a
    contiguous, 16-byte aligned (B, H, W, 64) tensor (NCHW channels_last
    memory permuted to NHWC is one, with no copy), H*W outside the gate,
    or an operand missing or of another shape, dtype or device."""
    if x.device.type == "cpu":
        return fused_srb_reference(x, ops, heads, eps)
    _cuda_only(x, "fused_srb")
    _check(x, ops, heads)
    lib = load_library()
    b, h, w, c = x.shape
    l = h * w
    d = ops["wout"].shape[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        r1, r, out = (torch.empty_like(x) for _ in range(3))
        qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=x.device)
        fused_srb.launches += 1
        _launch_conv_mish(lib, x, ops, r1, stream)
        _launch_conv_qkv(lib, r1, ops, r, qkv, stream)
        check(lib.fe_attn_epilogue(
            qkv.data_ptr(), r.data_ptr(),
            *(ops[k].data_ptr() for k in EPILOGUE_OPERANDS),
            x.data_ptr(), out.data_ptr(), b, l, d // heads, eps,
            int(x.dtype == torch.bfloat16), stream), "fe_attn_epilogue")
    return out


fused_srb.launches = 0
srb_conv_mish.launches = 0
srb_conv_qkv.launches = 0
