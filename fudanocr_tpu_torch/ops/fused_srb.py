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

`fused_srb` launches the hand-written CUDA kernels on CUDA tensors: the
two convolutions of csrc/fused_srb.cu, then the enhancer's two kernels of
csrc/fused_enhancer.cu, the second with the block input as its residual
(four launches per call; `fused_srb.launches` counts calls, and the
enhancer's own counter `fused_enhancer.launches` is not moved). CPU tensors
run `fused_srb_reference`, the plain PyTorch version. It never falls back
on a CUDA tensor: it launches or raises. Inference only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.ops.fused_enhancer import (EPILOGUE_OPERANDS,
                                                   check_cuda_operands,
                                                   enhancer_reference_fp32,
                                                   fused_enhancer_supported)

CONV_OPERANDS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b")


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
    `conv1`/`conv2` are (OIHW weight, bias); `bn1`/`bn2` as `fold_bn`
    takes them."""
    ops = dict(enhancer_ops)
    for name, (w, b), bn in (("conv1", conv1, bn1), ("conv2", conv2, bn2)):
        wf, bf = fold_bn(w, b, bn, bn_eps)
        ops[f"{name}_w"] = (wf.permute(2, 3, 1, 0).reshape(-1, wf.shape[0])
                            .to(dtype).contiguous())
        ops[f"{name}_b"] = bf.contiguous()
    return ops


def _conv_reference(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of NHWC x with (9*C, C) kernel-layout weights at x's
    dtype; fp32 accumulation, fp32 result."""
    c = x.shape[-1]
    oihw = w.float().reshape(3, 3, c, -1).permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), oihw, b, padding=1)
    return y.permute(0, 2, 3, 1)


def fused_srb_reference(x: torch.Tensor, ops: Dict[str, torch.Tensor],
                        heads: int = 4, eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version, (B, H, W, C) -> (B, H, W, C) at x's
    dtype, at the JAX kernel's rounding points. Works on any device; the
    CPU tests and TBSRN's CPU route use it."""
    dt = x.dtype
    b, h, w, c = x.shape
    r = _conv_reference(x, ops["conv1_w"], ops["conv1_b"])
    r = (r * torch.tanh(F.softplus(r))).to(dt)
    r = _conv_reference(r, ops["conv2_w"], ops["conv2_b"]).to(dt)
    out = enhancer_reference_fp32(r.reshape(b, h * w, c), ops, heads, eps)
    return (x.float() + out.view(b, h, w, c)).to(dt)


def _check(x: torch.Tensor, ops: Dict[str, torch.Tensor], heads: int) -> None:
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
    check_cuda_operands(x.view(b, h * w, c), ops, heads)
    for k in CONV_OPERANDS:
        t = ops[k]
        want = ((c,), torch.float32) if k.endswith("_b") else \
            ((9 * c, c), x.dtype)
        if ((tuple(t.shape), t.dtype) != want or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"fused_srb operand {k!r}: {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} does not fit "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")


def fused_srb(x: torch.Tensor, ops: Dict[str, torch.Tensor], heads: int = 4,
              eps: float = 1e-6) -> torch.Tensor:
    """One SRB on a channels-last (B, H, W, C) map -> the same shape.

    CPU tensors run `fused_srb_reference`. CUDA tensors launch the kernels
    (built at first use, see ops/_build.py) and raise on what they do not
    take: a dtype other than float32/bfloat16, a map that is not a
    contiguous, 16-byte aligned (B, H, W, 64) tensor (NCHW channels_last
    memory permuted to NHWC is one, with no copy), H*W outside the gate,
    or an operand of another shape, dtype or device."""
    if x.device.type == "cpu":
        return fused_srb_reference(x, ops, heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_srb: no kernel for {x.device}")
    from fudanocr_tpu_torch.ops._build import check, load_library

    _check(x, ops, heads)
    lib = load_library()
    b, h, w, c = x.shape
    l = h * w
    d = ops["wout"].shape[0]
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        r1, r, out = (torch.empty_like(x) for _ in range(3))
        qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=x.device)
        fused_srb.launches += 1
        for src, dst, name, act in ((x, r1, "conv1", 1), (r1, r, "conv2", 0)):
            check(lib.srb_conv3x3(src.data_ptr(), ops[f"{name}_w"].data_ptr(),
                                  ops[f"{name}_b"].data_ptr(), dst.data_ptr(),
                                  b, h, w, act, bf16, stream), "srb_conv3x3")
        check(lib.fe_qkv_proj(r.data_ptr(), ops["wtop"].data_ptr(),
                              ops["peqkv"].data_ptr(), qkv.data_ptr(), b * l,
                              l, bf16, stream), "fe_qkv_proj")
        check(lib.fe_attn_epilogue(
            qkv.data_ptr(), r.data_ptr(),
            *(ops[k].data_ptr() for k in EPILOGUE_OPERANDS),
            x.data_ptr(), out.data_ptr(), b, l, d // heads, eps, bf16,
            stream), "fe_attn_epilogue")
    return out


fused_srb.launches = 0
