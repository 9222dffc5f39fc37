"""Fused residual-add + reference LayerNorm: Hopper kernel + plain twin.

Port of fudanocr_tpu/ops/fused_layernorm.py. For (..., D) x and res,

    v = x + res                                (float32)
    y = (v - mean) / (unbiased_std + eps) * scale + bias

with float32 statistics and y rounded to x's dtype: the reference
LayerNorm (scene-text-telescope/model/transformer.py) applied after every
residual add of TBSRN's FeatureEnhancer (ln1/ln2) and of the text-focus
oracle's decoder (ln1-3).

`fused_residual_layernorm` is a `torch.autograd.Function`. Its forward
launches the hand-written kernel in csrc/fused_layernorm.cu on CUDA
tensors (one warp per row, the row held in registers, so x and res are
read once and y written once: the op is bound by device-memory bytes) and
runs `fused_residual_layernorm_reference` on CPU tensors. On a CUDA tensor
it launches or raises; it never falls back. Its backward is the closed
form of the JAX package's custom VJP (`_fused_bwd`) in plain PyTorch, as
the JAX package leaves it to XLA; there is no backward kernel.
`fused_residual_layernorm.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

MAX_FEATURES = 2048   # the kernel keeps a row in registers: 64 per lane


def torch_layer_norm(v: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(v - mean) / (unbiased_std + eps) * scale + bias, all in float32."""
    v = v.float()
    mean = v.mean(-1, keepdim=True)
    d = v - mean
    var = (d * d).sum(-1, keepdim=True) / max(v.shape[-1] - 1, 1)
    return d / (var.sqrt() + eps) * scale.float() + bias.float()


def fused_residual_layernorm_reference(x: torch.Tensor, res: torch.Tensor,
                                       scale: torch.Tensor,
                                       bias: torch.Tensor,
                                       eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version: LN(x + res) in float32, output at x's
    dtype. Differentiable by autograd; works on any device."""
    return torch_layer_norm(x.float() + res.float(), scale, bias,
                            eps).to(x.dtype)


def _layernorm_backward(x, res, scale, g, eps):
    """Closed-form VJP of LN(x + res) (fudanocr_tpu/ops/fused_layernorm.py
    _fused_bwd): returns (dv, dscale, dbias), dv in float32."""
    v = x.float() + res.float()
    n = v.shape[-1]
    mean = v.mean(-1, keepdim=True)
    d = v - mean
    var = (d * d).sum(-1, keepdim=True) / max(n - 1, 1)
    sig = var.sqrt()
    s = sig + eps
    g32 = g.float()
    gy = g32 * scale.float()
    # dL/dd_i = gy_i/s - (sum_j gy_j d_j) * d_i / ((n-1) * sig * s^2)
    proj = (gy * d).sum(-1, keepdim=True)
    dd = gy / s - proj * d / (max(n - 1, 1) * sig.clamp_min(1e-30) * s * s)
    dv = dd - dd.mean(-1, keepdim=True)
    dscale = (g32 * (d / s)).reshape(-1, n).sum(0).to(scale.dtype)
    dbias = g32.reshape(-1, n).sum(0).to(scale.dtype)
    return dv, dscale, dbias


def _check_cuda_operands(x, res, scale, bias) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_residual_layernorm takes float32 or bfloat16 "
                        f"x, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"fused_residual_layernorm needs 1 <= D <= "
                         f"{MAX_FEATURES}, got D={d}")
    if (res.shape != x.shape or res.dtype != x.dtype
            or res.device != x.device):
        raise ValueError(
            f"fused_residual_layernorm: res {tuple(res.shape)} {res.dtype} "
            f"on {res.device} does not match x {tuple(x.shape)} {x.dtype} "
            f"on {x.device}")
    if not (x.is_contiguous() and res.is_contiguous()):
        raise ValueError("fused_residual_layernorm needs contiguous x and "
                         "res")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.shape != (d,) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"fused_residual_layernorm: {name} must be a contiguous "
                f"float32 ({d},) tensor on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(x, res, scale, bias, eps):
    from fudanocr_tpu_torch.ops._build import check, load_library

    _check_cuda_operands(x, res, scale, bias)
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fused_residual_layernorm.launches += 1
        check(lib.ln_residual_fwd(
            x.data_ptr(), res.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), rows, d, eps, int(x.dtype == torch.bfloat16),
            stream), "ln_residual_fwd")
    return out


class _FusedResidualLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, res, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, res, scale)
        if x.device.type == "cpu":
            return fused_residual_layernorm_reference(x, res, scale, bias,
                                                      eps)
        if x.device.type != "cuda":
            raise ValueError(f"fused_residual_layernorm: no kernel for "
                             f"{x.device}")
        return _launch(x, res, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, res, scale = ctx.saved_tensors
        dv, dscale, dbias = _layernorm_backward(x, res, scale, g, ctx.eps)
        return dv.to(x.dtype), dv.to(res.dtype), dscale, dbias, None


def fused_residual_layernorm(x: torch.Tensor, res: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """LN(x + res) with the reference's std + eps, unbiased variance;
    output at x's dtype; differentiable in x, res, scale and bias.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    (built at first use, see ops/_build.py) and raise on what it does not
    take: x other than float32/bfloat16, res of another shape, dtype or
    device, non-contiguous x or res, scale/bias not contiguous float32
    (D,) on x's device, or D outside 1..2048."""
    return _FusedResidualLayerNorm.apply(x, res, scale, bias, eps)


fused_residual_layernorm.launches = 0
