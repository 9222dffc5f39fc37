"""Bidirectional GRU over pre-projected inputs: the Hopper kernel's wrapper
and its plain twin (port of fudanocr_tpu/ops/fused_gru.py).

TSRN's SpatialGRU runs a bidirectional GRU along one spatial axis with the
other folded into the batch: at the TextZoom LR geometry (16x64) that is
(B*64, 16, ...) and (B*16, 64, ...) sequences with hidden 32 per
direction. The input projection of every step is hoisted out of the
recurrence (nn/recurrent.py); `fused_bigru` runs the recurrence of both
directions in one launch of the kernel in csrc/fused_gru.cu (see its
header for the design and the bound), with the gate math of the JAX
`_gru_scan` (nn/recurrent.py:38-46): gates [r, z, n], fp32,

    g = h @ wh + bh;  r = sigmoid(x_r + g_r);  z = sigmoid(x_z + g_z)
    n = tanh(x_n + r * g_n);  h' = (1 - z) * n + z * h

CPU tensors run `fused_bigru_reference`, an explicit loop over T at the
same rounding points. CUDA tensors launch the kernel and raise on what it
does not take; nothing falls back. The kernel has no backward: the
training path keeps cuDNN's GRU (nn/recurrent.py), as the JAX package
keeps its scan.
"""

from __future__ import annotations

import torch

KERNEL_HIDDEN = (8, 16, 24, 32)   # hidden sizes the kernel is built for


def fused_gru_supported(rows: int, t: int, hidden: int) -> bool:
    """The JAX package's gate for the fused route
    (fudanocr_tpu/ops/fused_gru.py:35). The port's route also needs a
    hidden size in `KERNEL_HIDDEN`."""
    return (rows % 256 == 0 and 2 <= t <= 128 and hidden % 8 == 0
            and hidden <= 512)


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
        check(lib.gru_bidir_fwd(
            xproj_f.data_ptr(), xproj_b.data_ptr(), wh_f.data_ptr(),
            bh_f.data_ptr(), wh_b.data_ptr(), bh_b.data_ptr(), y.data_ptr(),
            rows, t_len, hidden, torch.cuda.current_stream().cuda_stream),
            "gru_bidir_fwd")
    return y


fused_bigru.launches = 0
