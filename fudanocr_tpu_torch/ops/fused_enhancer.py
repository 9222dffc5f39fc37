"""The whole TBSRN FeatureEnhancer at inference: Hopper kernel + plain twin.

Port of fudanocr_tpu/ops/fused_enhancer.py. For (B, L, C=64) raw tokens
and the (L, 64) 2D positional code it computes, per image,

    x = [tokens | pe]                         (L, D=128)
    qkv = tokens @ Wqkv[:C] + (pe @ Wqkv[C:] + b)
    attn = 4-head softmax attention (dh = 32, scale 1/sqrt(dh))
    x1 = LN1(x + attn @ Wout + bout)
    x2 = LN2(x1 + relu(x1 @ W1 + b1) @ W2 + b2)
    out = x2 @ Wp + bp                        (L, 64)

with the reference's std+eps LayerNorm, fp32 accumulation everywhere, and
activations rounded to the compute dtype at the sublayer boundaries the
JAX kernel uses (qkv, attn, out, x1, relu output, y, x2, out).

`fused_enhancer` launches the hand-written CUDA kernel in
csrc/fused_enhancer.cu on CUDA tensors (two launches: the qkv projection
into a scratch buffer, then attention with the row-local epilogue) and
uses `fused_enhancer_reference`, the plain PyTorch version of the same
math, on CPU tensors. It never falls back on a CUDA tensor: it launches or
raises. Inference only; there is no backward.

Both take the operand dict built by `enhancer_operands`, the counterpart
of the JAX function of the same name: weights at the compute dtype, biases
and LN parameters in fp32, and the batch-constant qkv term of the PE
(`peqkv`) computed once, so callers can cache it per (weights, L, dtype).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from fudanocr_tpu_torch.ops.fused_layernorm import torch_layer_norm

D_MODEL = 128   # the kernel's model width: 64 token + 64 PE channels
# the operands of `fe_attn_epilogue`, in its argument order, and all of them
EPILOGUE_OPERANDS = ("pe", "wout", "bout", "ln1_scale", "ln1_bias", "w1", "b1",
                     "w2", "b2", "ln2_scale", "ln2_bias", "wp", "bp")
ENHANCER_OPERANDS = ("peqkv", "wtop") + EPILOGUE_OPERANDS


def fused_enhancer_supported(l: int, d_model: int, heads: int) -> bool:
    """The JAX package's gate for the fused-enhancer route
    (fudanocr_tpu/ops/fused_enhancer.py:49-53)."""
    return (512 <= l <= 2048 and l % 256 == 0 and d_model % 128 == 0
            and d_model <= 256 and d_model % heads == 0
            and (d_model // heads) % 8 == 0)


def enhancer_operands(params: Dict[str, torch.Tensor], pe: torch.Tensor,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Kernel operands from the FeatureEnhancer weights.

    `params` holds (in, out)-layout matrices and vectors: wqkv (D, 3D),
    bqkv, wout (D, D), bout, ln1_scale, ln1_bias, w1, b1, w2, b2,
    ln2_scale, ln2_bias, wp (D, C), bp. `pe` is the (L, D - C) positional
    code. The PE's qkv contribution pe @ Wqkv[C:] + b is the same for every
    image, so it is computed here once (a plain matmul, as the JAX package
    leaves it to XLA outside its kernel)."""
    c = params["wqkv"].shape[0] - pe.shape[1]
    wqkv = params["wqkv"].to(dtype)
    pe = pe.to(dtype).contiguous()
    peqkv = pe.float() @ wqkv[c:].float() + params["bqkv"].float()
    ops = {"pe": pe, "peqkv": peqkv.contiguous(),
           "wtop": wqkv[:c].contiguous()}
    for k in ("wout", "w1", "w2", "wp"):
        ops[k] = params[k].to(dtype).contiguous()
    for k in ("bout", "ln1_scale", "ln1_bias", "b1", "b2", "ln2_scale",
              "ln2_bias", "bp"):
        ops[k] = params[k].float().contiguous()
    return ops


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b with fp32 accumulation; x and w already at the compute
    dtype, b fp32. Returns fp32."""
    return x.float() @ w.float() + b


def fused_enhancer_reference(tokens: torch.Tensor, ops: Dict[str, torch.Tensor],
                             heads: int = 4, eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same math, unfused, with a
    max-shifted softmax. Works on any device; the CPU tests and the CPU
    path of FeatureEnhancer use it."""
    return enhancer_reference_fp32(tokens, ops, heads, eps).to(tokens.dtype)


def enhancer_reference_fp32(tokens: torch.Tensor,
                            ops: Dict[str, torch.Tensor], heads: int = 4,
                            eps: float = 1e-6) -> torch.Tensor:
    """`fused_enhancer_reference` with the final projection left in fp32,
    unrounded: the whole-SRB kernel adds its residual to it before it
    rounds (ops/fused_srb.py)."""
    dt = tokens.dtype
    b, l, _ = tokens.shape
    d = ops["wout"].shape[0]
    dh = d // heads
    qkv = (_dense(tokens, ops["wtop"], ops["peqkv"])).to(dt).float()
    q, k, v = (t.view(b, l, heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    # one head at a time bounds the fp32 (B, L, L) scores to one copy
    attn = torch.cat([
        ((q[:, h] @ k[:, h].transpose(-1, -2)) / math.sqrt(dh)).softmax(-1)
        @ v[:, h] for h in range(heads)], dim=-1).to(dt)
    x = torch.cat([tokens, ops["pe"].expand(b, l, -1)], dim=-1)
    out = _dense(attn, ops["wout"], ops["bout"]).to(dt)
    x1 = torch_layer_norm(x.float() + out.float(), ops["ln1_scale"],
                          ops["ln1_bias"], eps).to(dt)
    y = torch.relu(_dense(x1, ops["w1"], ops["b1"])).to(dt)
    y = _dense(y, ops["w2"], ops["b2"]).to(dt)
    x2 = torch_layer_norm(x1.float() + y.float(), ops["ln2_scale"],
                          ops["ln2_bias"], eps).to(dt)
    return _dense(x2, ops["wp"], ops["bp"])


def check_cuda_operands(tokens: torch.Tensor, ops: Dict[str, torch.Tensor],
                        heads: int) -> None:
    """Raise on tokens or enhancer operands the kernel does not take."""
    if tokens.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_enhancer takes float32 or bfloat16 tokens, "
                        f"got {tokens.dtype}")
    if tokens.dim() != 3 or not tokens.is_contiguous():
        raise ValueError("fused_enhancer needs contiguous (B, L, C) tokens, "
                         f"got shape {tuple(tokens.shape)} strides "
                         f"{tokens.stride()}")
    b, l, c = tokens.shape
    d = ops["wout"].shape[0]
    if d != D_MODEL or c != 64 or ops["pe"].shape[-1] != 64:
        raise ValueError(f"fused_enhancer needs C + 64 == D == {D_MODEL}, got "
                         f"C={c}, PE width {ops['pe'].shape[-1]}, D={d}")
    if d % heads or d // heads not in (32, 64):
        raise ValueError(f"fused_enhancer needs head width 32 or 64, got "
                         f"D={d} over {heads} heads")
    if b < 1 or l < 1:
        raise ValueError(f"empty tokens {tuple(tokens.shape)}")
    want = {"pe": (l, d - c), "peqkv": (l, 3 * d), "wtop": (c, 3 * d),
            "wout": (d, d), "w1": (d, d), "w2": (d, d), "wp": (d, c)}
    for k in ENHANCER_OPERANDS:
        t = ops[k]
        fp32 = k not in ("pe", "wtop", "wout", "w1", "w2", "wp")
        if (t.device != tokens.device or not t.is_contiguous()
                or t.dtype != (torch.float32 if fp32 else tokens.dtype)
                or (k in want and tuple(t.shape) != want[k])):
            raise ValueError(
                f"fused_enhancer operand {k!r}: {tuple(t.shape)} "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()}) "
                f"does not fit tokens {tuple(tokens.shape)} {tokens.dtype} "
                f"on {tokens.device}")


def fused_enhancer(tokens: torch.Tensor, ops: Dict[str, torch.Tensor],
                   heads: int = 4, eps: float = 1e-6) -> torch.Tensor:
    """The FeatureEnhancer on (B, L, C) tokens -> (B, L, C_out).

    CPU tensors run `fused_enhancer_reference`. CUDA tensors launch the
    hand-written kernel (built at first use, see ops/_build.py) and raise
    on anything it does not take: dtype other than fp32/bf16, a
    non-contiguous or wrong-device operand, C + 64 != D, or a head width
    other than 32 or 64. `fused_enhancer.launches` counts kernel launches
    (two per call)."""
    if tokens.device.type == "cpu":
        return fused_enhancer_reference(tokens, ops, heads, eps)
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_enhancer: no kernel for {tokens.device}")
    from fudanocr_tpu_torch.ops._build import check, load_library

    check_cuda_operands(tokens, ops, heads)
    lib = load_library()
    b, l, c = tokens.shape
    d = ops["wout"].shape[0]
    bf16 = int(tokens.dtype == torch.bfloat16)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream().cuda_stream
        qkv = torch.empty((b, l, 3 * d), dtype=tokens.dtype,
                          device=tokens.device)
        out = torch.empty((b, l, ops["wp"].shape[1]), dtype=tokens.dtype,
                          device=tokens.device)
        fused_enhancer.launches += 1
        check(lib.fe_qkv_proj(tokens.data_ptr(), ops["wtop"].data_ptr(),
                              ops["peqkv"].data_ptr(), qkv.data_ptr(),
                              b * l, l, bf16, stream), "fe_qkv_proj")
        fused_enhancer.launches += 1
        check(lib.fe_attn_epilogue(
            qkv.data_ptr(), tokens.data_ptr(),
            *(ops[k].data_ptr() for k in EPILOGUE_OPERANDS),
            None, out.data_ptr(), b, l, d // heads, eps, bf16, stream),
            "fe_attn_epilogue")
    return out


fused_enhancer.launches = 0
