"""Bidirectional GRU: the Hopper kernel's wrappers and their plain twins
(port of fudanocr_tpu/ops/fused_gru.py, and of the input projections that
JAX's `BiGRU` puts in front of it, fudanocr_tpu/nn/recurrent.py:76-122).

TSRN's SpatialGRU runs a bidirectional GRU along one spatial axis with the
other folded into the batch: at the TextZoom LR geometry (16x64) that is
(B*64, 16, 64) and (B*16, 64, 64) sequences with hidden 32 per direction.
Two entries launch the one kernel of csrc/fused_gru.cu (see its header for
the design and the bound), both directions in one launch, every product
on the tensor cores in split TF32, the gate math of the JAX `_gru_scan`
(nn/recurrent.py:38-46): gates [r, z, n], fp32,

    g = h @ wh + bh;  r = sigmoid(x_r + g_r);  z = sigmoid(x_z + g_z)
    n = tanh(x_n + r * g_n);  h' = (1 - z) * n + z * h

* `fused_bigru_x(x, w_ih_f, b_ih_f, w_hh_f, b_hh_f, w_ih_b, ..., hidden)`:
  the whole module, x (B', T, C) in bf16 or fp32 and torch's GRU
  parameters as they are; the input projections x_g = fp32(x) W_ih^T +
  b_ih run inside the kernel. The route of nn/recurrent.BiGRU.
* `fused_bigru(xproj_f, xproj_b, wh_f, bh_f, wh_b, bh_b, hidden)`: the
  counterpart of JAX's `fused_bigru`, over projections computed outside
  and JAX's (H, 3H) hidden weights.

CPU tensors run the plain versions (`fused_bigru_x_reference`,
`fused_bigru_reference`: F.linear in fp32, then an explicit loop over T at
the same rounding points). CUDA tensors launch the kernel and raise on
what it does not take; nothing falls back. Both count launches on
`fused_bigru.launches`. The kernel has no backward: the training path
keeps cuDNN's GRU (nn/recurrent.py), as the JAX package keeps its scan.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_HIDDEN = (8, 16, 24, 32)   # hidden sizes the kernel is built for
KERNEL_MAX_C = 64                 # input features its projection takes


def fused_gru_supported(rows: int, t: int, hidden: int) -> bool:
    """The JAX package's gate for the fused route
    (fudanocr_tpu/ops/fused_gru.py:35). The port's route also needs a
    hidden size in `KERNEL_HIDDEN`."""
    return (rows % 256 == 0 and 2 <= t <= 128 and hidden % 8 == 0
            and hidden <= 512)


def kernel_takes(c: int, hidden: int) -> bool:
    """Whether the kernel takes C input features and `hidden` units: H in
    `KERNEL_HIDDEN`, C a multiple of 8 up to `KERNEL_MAX_C`."""
    return hidden in KERNEL_HIDDEN and c % 8 == 0 and 8 <= c <= KERNEL_MAX_C


def _gru_direction(xproj: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    hidden = wh.shape[0]
    h = xproj.new_zeros(xproj.shape[0], hidden)
    ys = [None] * xproj.shape[1]
    steps = range(xproj.shape[1])
    for t in (reversed(steps) if reverse else steps):
        g = h @ wh + bh
        xr, xz, xn = xproj[:, t].split(hidden, dim=-1)
        gr, gz, gn = g.split(hidden, dim=-1)
        r = torch.sigmoid(xr + gr)
        z = torch.sigmoid(xz + gz)
        n = torch.tanh(xn + r * gn)
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack(ys, dim=1)


def fused_bigru_reference(xproj_f: torch.Tensor, xproj_b: torch.Tensor,
                          wh_f: torch.Tensor, bh_f: torch.Tensor,
                          wh_b: torch.Tensor, bh_b: torch.Tensor,
                          hidden: int) -> torch.Tensor:
    """The plain PyTorch version: (B', T, 3H) forward and backward
    projections -> (B', T, 2H) float32, forward direction in [0, H)."""
    args = [t.float() for t in (xproj_f, xproj_b, wh_f, bh_f, wh_b, bh_b)]
    if args[2].shape != (hidden, 3 * hidden):
        raise ValueError(f"fused_bigru: wh {tuple(wh_f.shape)} is not "
                         f"({hidden}, {3 * hidden})")
    return torch.cat([_gru_direction(args[0], args[2], args[3], False),
                      _gru_direction(args[1], args[4], args[5], True)], -1)


def _check(xproj_f, xproj_b, wh_f, bh_f, wh_b, bh_b, hidden) -> None:
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"fused_bigru: the kernel takes hidden sizes "
                         f"{KERNEL_HIDDEN}, got {hidden}")
    if xproj_f.dim() != 3 or xproj_f.shape[-1] != 3 * hidden:
        raise ValueError(f"fused_bigru: xproj {tuple(xproj_f.shape)} is not "
                         f"(B', T, {3 * hidden})")
    want = ((xproj_b, tuple(xproj_f.shape)), (wh_f, (hidden, 3 * hidden)),
            (wh_b, (hidden, 3 * hidden)), (bh_f, (3 * hidden,)),
            (bh_b, (3 * hidden,)))
    for t, shape in ((xproj_f, tuple(xproj_f.shape)),) + want:
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != xproj_f.device or not t.is_contiguous()):
            raise ValueError(f"fused_bigru takes contiguous float32 operands "
                             f"on one CUDA device: got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, want {shape}")
    if xproj_f.numel() == 0:
        raise ValueError(f"fused_bigru: empty xproj {tuple(xproj_f.shape)}")
    for t in (xproj_f, xproj_b):
        if t.data_ptr() % 8:
            raise ValueError("fused_bigru: the projections must start on an "
                             "8-byte boundary (the kernel loads pairs)")


def fused_bigru(xproj_f: torch.Tensor, xproj_b: torch.Tensor,
                wh_f: torch.Tensor, bh_f: torch.Tensor,
                wh_b: torch.Tensor, bh_b: torch.Tensor,
                hidden: int) -> torch.Tensor:
    """(B', T, 3H) forward / backward projections, (H, 3H) hidden weights
    and (3H,) biases per direction -> (B', T, 2H) float32.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    (built at first use, see ops/_build.py) and raise on anything it does
    not take: a hidden size outside `KERNEL_HIDDEN`, or operands that are
    not contiguous float32 of those shapes on one device.
    `fused_bigru.launches` counts launches."""
    if xproj_f.device.type == "cpu":
        return fused_bigru_reference(xproj_f, xproj_b, wh_f, bh_f, wh_b,
                                     bh_b, hidden)
    if xproj_f.device.type != "cuda":
        raise ValueError(f"fused_bigru: no kernel for {xproj_f.device}")
    from fudanocr_tpu_torch.ops._build import check, load_library

    _check(xproj_f, xproj_b, wh_f, bh_f, wh_b, bh_b, hidden)
    rows, t_len, _ = xproj_f.shape
    lib = load_library()
    with torch.cuda.device(xproj_f.device):
        y = torch.empty((rows, t_len, 2 * hidden), dtype=torch.float32,
                        device=xproj_f.device)
        fused_bigru.launches += 1
        # the kernel reads torch's (3H, H) hidden weights
        wt_f, wt_b = wh_f.t().contiguous(), wh_b.t().contiguous()
        check(lib.gru_bidir_fwd(
            xproj_f.data_ptr(), xproj_b.data_ptr(), wt_f.data_ptr(),
            bh_f.data_ptr(), wt_b.data_ptr(), bh_b.data_ptr(), y.data_ptr(),
            rows, t_len, hidden, torch.cuda.current_stream().cuda_stream),
            "gru_bidir_fwd")
    return y


fused_bigru.launches = 0


def fused_bigru_x_reference(x: torch.Tensor, w_ih_f: torch.Tensor,
                            b_ih_f: torch.Tensor, w_hh_f: torch.Tensor,
                            b_hh_f: torch.Tensor, w_ih_b: torch.Tensor,
                            b_ih_b: torch.Tensor, w_hh_b: torch.Tensor,
                            b_hh_b: torch.Tensor, hidden: int,
                            out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of `fused_bigru_x`, at the rounding points
    of the JAX module: x cast to fp32, each direction's projection
    F.linear(x, W_ih, b_ih) in fp32, the recurrence of
    `fused_bigru_reference`, the result cast to `out_dtype` (x's dtype
    unless given)."""
    xf = x.float()
    y = fused_bigru_reference(
        F.linear(xf, w_ih_f.float(), b_ih_f.float()),
        F.linear(xf, w_ih_b.float(), b_ih_b.float()),
        w_hh_f.float().t(), b_hh_f, w_hh_b.float().t(), b_hh_b, hidden)
    return y.to(out_dtype or x.dtype)


def _check_x(x, params, hidden, out_dtype) -> None:
    if x.dim() != 3 or not kernel_takes(x.shape[-1], hidden):
        raise ValueError(f"fused_bigru_x: the kernel takes x (B', T, C) with "
                         f"C a multiple of 8 up to {KERNEL_MAX_C} and hidden "
                         f"in {KERNEL_HIDDEN}: got {tuple(x.shape)}, hidden "
                         f"{hidden}")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or out_dtype not in (x.dtype, torch.float32)
            or not x.is_contiguous() or x.numel() == 0
            or x.data_ptr() % (2 * x.element_size())):
        raise ValueError(f"fused_bigru_x takes a non-empty contiguous fp32 or "
                         f"bf16 x starting on a pair boundary, with an output "
                         f"in x's dtype or fp32: got {tuple(x.shape)} "
                         f"{x.dtype} -> {out_dtype}")
    c, g3 = x.shape[-1], 3 * hidden
    shapes = ((g3, c), (g3,), (g3, hidden), (g3,)) * 2
    for t, shape in zip(params, shapes):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"fused_bigru_x takes contiguous float32 GRU "
                             f"parameters on x's device: got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want {shape}")


def fused_bigru_x(x: torch.Tensor, w_ih_f: torch.Tensor, b_ih_f: torch.Tensor,
                  w_hh_f: torch.Tensor, b_hh_f: torch.Tensor,
                  w_ih_b: torch.Tensor, b_ih_b: torch.Tensor,
                  w_hh_b: torch.Tensor, b_hh_b: torch.Tensor, hidden: int,
                  out_dtype=None) -> torch.Tensor:
    """The bidirectional GRU over x (B', T, C), bf16 or fp32, with torch's
    parameters per direction (`weight_ih_l0` (3H, C), `bias_ih_l0` (3H,),
    `weight_hh_l0` (3H, H), `bias_hh_l0` (3H,), then the `_reverse` four)
    -> (B', T, 2H) in `out_dtype` (x's dtype unless given), forward
    direction in [0, H).

    CPU tensors run the plain version. CUDA tensors launch the kernel
    (built at first use, see ops/_build.py) and raise on anything it does
    not take: C or H outside `kernel_takes`, x not contiguous fp32 or bf16,
    an output neither in x's dtype nor fp32, parameters not contiguous
    float32 of those shapes on x's device.
    Launches count on `fused_bigru.launches`."""
    params = (w_ih_f, b_ih_f, w_hh_f, b_hh_f, w_ih_b, b_ih_b, w_hh_b, b_hh_b)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return fused_bigru_x_reference(x, *params, hidden, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bigru_x: no kernel for {x.device}")
    from fudanocr_tpu_torch.ops._build import check, load_library

    _check_x(x, params, hidden, out_dtype)
    rows, t_len, c = x.shape
    lib = load_library()
    with torch.cuda.device(x.device):
        y = torch.empty((rows, t_len, 2 * hidden), dtype=out_dtype,
                        device=x.device)
        fused_bigru.launches += 1
        check(lib.gru_bidir_x_fwd(
            x.data_ptr(), *(t.data_ptr() for t in params), y.data_ptr(),
            rows, t_len, c, hidden, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "gru_bidir_x_fwd")
    return y
