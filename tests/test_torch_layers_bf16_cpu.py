"""The bf16 convolutions and products of `fudanocr_tpu_torch/nn/layers.py`
on the CPU, at CascadeMiT's shapes (the narrow cut of
tests/test_torch_seg_bf16.py: embed 8, heads (1, 2, 5, 8), sr ratios
(8, 4, 2, 1), on a 96x128 image), against the float32 computation on the
same bf16 values rounded to bf16 once: equal, or within one bf16 ulp.

On hosts with AMX (`amx_bf16` in /proc/cpuinfo) torch 2.13's oneDNN bf16
convolution returns wrong sums where kernel = stride: the spatial
reduction `sr` of stages 0 and 1 (k = s = 8 over 8 channels, k = s = 4
over 16): 4.3 away from the once-rounded sum at k = s = 8 in this test,
without the repair, where the other shapes are within one ulp.
`layers.conv2d` therefore convolves a bf16 CPU input in float32 and
rounds once. To see whether a
CPU bf16 result depends on the host's ISA, run the same test with
`ONEDNN_MAX_CPU_ISA=AVX512_CORE` (oneDNN without AMX) and without it.
"""

import pytest
import torch
from torch import nn

from fudanocr_tpu_torch.nn.layers import conv2d, linear

BF16 = torch.bfloat16

# (input (B, C, H, W), out channels, kernel, stride, padding, groups)
CONVS = {
    "sr-stage0-k8s8": ((2, 8, 24, 32), 8, 8, 8, 0, 1),
    "sr-stage1-k4s4": ((2, 16, 12, 16), 16, 4, 4, 0, 1),
    "sr-stage2-k2s2": ((2, 40, 6, 8), 40, 2, 2, 0, 1),
    "patch-embed0-k7s4": ((2, 3, 96, 128), 8, 7, 4, 3, 1),
    "patch-embed1-k3s2": ((2, 8, 24, 32), 16, 3, 2, 1, 1),
    "patch-embed3-k3s2": ((2, 40, 6, 8), 64, 3, 2, 1, 1),
    "ffn-fc1-k1": ((2, 8, 24, 32), 32, 1, 1, 0, 1),
    "ffn-dw-k3": ((2, 32, 24, 32), 32, 3, 1, 1, 32),
    "ffn-fc2-k1": ((2, 256, 3, 4), 64, 1, 1, 0, 1),
    "head-fuse-k1": ((2, 128, 24, 32), 32, 1, 1, 0, 1),
}
LINEARS = {"q-stage0": ((2, 768, 8), 8), "kv-stage1": ((2, 12, 16), 32),
           "qkv-stage3": ((2, 12, 64), 192)}


def _ulp(r: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at r (8 significant bits)."""
    _, e = torch.frexp(r.float())
    return torch.ldexp(torch.ones_like(r, dtype=torch.float32), e - 8)


def _check(got: torch.Tensor, want32: torch.Tensor) -> None:
    assert got.dtype == BF16
    want = want32.to(BF16)
    diff = (got.float() - want.float()).abs()
    worst = (diff / _ulp(want)).max().item()
    assert worst <= 1.0, (diff.max().item(), worst)


@pytest.mark.parametrize("name", list(CONVS))
def test_bf16_conv_rounds_once(name):
    shape, cout, k, s, p, groups = CONVS[name]
    gen = torch.Generator().manual_seed(len(name))
    m = nn.Conv2d(shape[1], cout, k, s, p, groups=groups)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                       * (m.weight[0].numel() ** -0.5))
        m.bias.copy_(torch.randn(cout, generator=gen) * 0.1)
    x = torch.randn(shape, generator=gen).to(BF16)
    got = conv2d(m, x)
    want = torch.nn.functional.conv2d(
        x.float(), m.weight.to(BF16).float(), m.bias.to(BF16).float(), s, p,
        1, groups)
    assert want.abs().mean() > 0.3   # sums of a real size
    _check(got, want)


@pytest.mark.parametrize("name", list(LINEARS))
def test_bf16_linear_rounds_once(name):
    shape, cout = LINEARS[name]
    gen = torch.Generator().manual_seed(len(name))
    m = nn.Linear(shape[-1], cout)
    with torch.no_grad():
        m.bias.copy_(torch.randn(cout, generator=gen) * 0.1)
    x = torch.randn(shape, generator=gen).to(BF16)
    got = linear(m, x)
    want = torch.nn.functional.linear(x.float(), m.weight.to(BF16).float(),
                                      m.bias.to(BF16).float())
    _check(got, want)
