"""A CPU model of how the bf16 whole-SRB conv kernels (B9,
fudanocr_tpu_torch/csrc/fused_srb.cu `srb_conv_tc`) index their data, held
against the port's plain conv and the JAX package's own `_conv3x3`
(fudanocr_tpu/ops/fused_srb.py:63, plain jnp, run on numpy arrays):

* `kernel_conv_model` computes the conv as the kernel does: the persistent
  loop's tiles (block b takes tiles b, b + grid, ...), the three TMA bands
  of 130 tokens a tile with zeros where a box leaves the image's [0, L),
  stored with the 128-byte swizzle and read back at ldmatrix's addresses,
  the per-row W-edge masks, and B read from `pack_sw128`'s layout at the
  addresses wgmma's descriptor gives, 9 taps x 4 k16 steps summed in fp32.
  Over every (H, W) of a grid that JAX's gate admits it equals both convs
  in fp32 at rtol 1e-6, atol 1e-5 (FP32_ATOL: sums of 576 products in
  another order; outputs reach ~3, and the model and the plain conv are
  each up to 3.2e-6 from an fp64 conv) and, on bf16 inputs whose products
  and sums are exact in fp32 (multiples of 1/8 and 1/64), at 0. At H = 1
  it is held against the plain conv alone: JAX's `_conv3x3` shifts the
  token matrix by up to W + 1 rows, more than its L = W rows, and fails
  to concatenate;
* the tiles cover each output row exactly once, for the gate's grid at
  batch 1 and 3 on a grid of 5 blocks and of 132 (the H100's SMs);
* `pack_sw128` is a permutation that `unpack_sw128` inverts, and the packed
  operands of `srb_operands` unpack to the BN-folded OIHW weights and wtop
  exactly; the model block's operand cache follows the enhancer's weights;
* `srb_conv_qkv_reference` (the plain twin of the conv2 + qkv launch)
  equals `_conv_reference` followed by the qkv stage of
  `enhancer_reference_fp32`, bit for bit, in fp32 and bf16.
"""

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.models.sr.tbsrn import TransformerResidualBlock
from fudanocr_tpu_torch.ops import fused_srb as fs
from fudanocr_tpu_torch.ops.fused_enhancer import _dense
from torch_threads import one_torch_thread  # noqa: F401

C, ROWS, SMS = 64, 128, 132
FP32_ATOL = 1e-5
H_GRID = (1, 2, 3, 4, 5, 8, 12, 16, 20, 32, 64)
W_GRID = (8, 16, 32, 48, 64, 96, 128, 256, 512, 1024, 2048)
GATE_GRID = [(h, w) for h in H_GRID for w in W_GRID
             if fs.fused_srb_supported(h, w, C, 4)]


def kernel_tiles(b: int, l: int, sms: int):
    """(block, image, first row) of every tile, in the order the kernel's
    blocks walk them: one block an SM, no more blocks than tiles."""
    per_img = l // ROWS
    tiles = b * per_img
    grid = min(tiles, sms)
    return [(blk, t // per_img, t % per_img * ROWS)
            for blk in range(grid) for t in range(blk, tiles, grid)]


def _swizzled_columns(rows: torch.Tensor, chunk: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """The column of element k of 16-byte chunk `chunk` of a 128-byte row
    `rows` in a 1024-byte-aligned buffer with the 128-byte swizzle."""
    return ((chunk ^ (rows % 8)) * 8 + k % 8)


def kernel_conv_model(x: torch.Tensor, wg: torch.Tensor, bias: torch.Tensor,
                      w: int, sms: int = SMS):
    """conv3x3(x, W') + b' for x (B, L, 64) at the kernel's dtype, wg the
    packed W' (`pack_sw128`), as the kernel indexes them; fp32 (B, L, 64)
    and the times each output row was written."""
    b, l, _ = x.shape
    out = torch.zeros(b, l, C)
    cover = torch.zeros(b, l, dtype=torch.int64)
    m = torch.arange(ROWS)
    kk = torch.arange(16)          # k within a k16 step
    n = torch.arange(C)
    band_rows = torch.arange(ROWS + 2)
    for _, img, r0 in kernel_tiles(b, l, sms):
        # TMA: three boxes of ROWS + 2 tokens, rows outside [0, L) zero,
        # landing in shared memory with the 128-byte swizzle
        bands = []
        for dy in range(3):
            f = r0 + (dy - 1) * w - 1 + band_rows
            box = torch.where(((f >= 0) & (f < l))[:, None],
                              x[img, f.clamp(0, l - 1)], 0)
            smem = torch.empty_like(box)
            cols = _swizzled_columns(band_rows[:, None],
                                     torch.arange(C)[None, :] // 8,
                                     torch.arange(C)[None, :])
            smem.scatter_(1, cols, box)
            bands.append(smem)
        wcol = (r0 + m) % w
        acc = torch.zeros(ROWS, C)
        for tap in range(9):
            dy, dx = tap // 3, tap % 3 - 1
            br = m + dx + 1                      # the band row of each row
            keep = (torch.ones(ROWS, dtype=torch.bool) if dx == 0 else
                    wcol > 0 if dx < 0 else wcol < w - 1)
            for ks in range(4):
                # A: ldmatrix of chunks 2ks, 2ks + 1 of the band rows
                a_cols = _swizzled_columns(br[:, None],
                                           2 * ks + kk[None, :] // 8,
                                           kk[None, :])
                a = bands[dy][br[:, None], a_cols] * keep[:, None]
                # B: the descriptor at rows tap*64 + n, 32*ks bytes in
                b_cols = _swizzled_columns(n[None, :],
                                           2 * ks + kk[:, None] // 8,
                                           kk[:, None])
                bm = wg[tap * C + n[None, :], b_cols]        # (16, 64)
                acc += a.float() @ bm.float()
        out[img, r0:r0 + ROWS] = acc + bias
        cover[img, r0:r0 + ROWS] += 1
    return out, cover


def _jax_conv(x: torch.Tensor, w576: torch.Tensor, bias: torch.Tensor,
              width: int) -> np.ndarray:
    jnp = pytest.importorskip("jax.numpy")
    from fudanocr_tpu.ops.fused_srb import _conv3x3

    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    wj = jnp.asarray(w576.float().numpy(), dt)
    bj = jnp.asarray(bias.numpy())
    return np.stack([np.asarray(_conv3x3(
        jnp.asarray(xi.float().numpy(), dt), wj, bj, width, dt))
        for xi in x])


def _inputs(h: int, w: int, dtype, exact: bool, b: int = 2):
    """x (B, L, 64), W' (576, 64) and b' at `dtype`; `exact`: multiples
    of 1/8, 1/64 and 1/512, whose products and sums are exact in fp32."""
    rng = np.random.default_rng(h * 4096 + w)
    l = h * w
    if exact:
        x = rng.integers(-16, 17, (b, l, C)) / 8
        wt = rng.integers(-32, 33, (9 * C, C)) / 64
        bias = rng.integers(-64, 65, C) / 512
    else:
        x = 0.5 * rng.standard_normal((b, l, C))
        wt = 0.05 * rng.standard_normal((9 * C, C))
        bias = 0.1 * rng.standard_normal(C)
    return (torch.tensor(x, dtype=torch.float32).to(dtype),
            torch.tensor(wt, dtype=torch.float32).to(dtype),
            torch.tensor(bias, dtype=torch.float32))


@pytest.mark.parametrize("h,w", GATE_GRID)
def test_kernel_model_matches_the_convs(h, w):
    for dtype, exact in ((torch.float32, False), (torch.bfloat16, True)):
        x, w576, bias = _inputs(h, w, dtype, exact)
        got, cover = kernel_conv_model(x, fs.pack_sw128(w576), bias, w,
                                       sms=5)
        assert torch.equal(cover, torch.ones_like(cover))
        plain = fs._conv_reference(x.view(2, h, w, C), w576, bias)
        plain = plain.reshape(2, h * w, C)
        wants = [plain]
        if h > 1:   # JAX's shifts by W + 1 tokens exceed L = W at H = 1
            wants.append(torch.from_numpy(_jax_conv(x, w576, bias, w)))
        for want in wants:
            if exact:
                assert torch.equal(got, want), (h, w, dtype)
                assert torch.equal(got.to(dtype), want.to(dtype))
            else:
                torch.testing.assert_close(got, want, rtol=1e-6,
                                           atol=FP32_ATOL)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("sms", [5, SMS])
def test_tiles_cover_each_row_once(b, sms):
    for h, w in GATE_GRID:
        l = h * w
        cover = torch.zeros(b, l, dtype=torch.int64)
        blocks = set()
        for blk, img, r0 in kernel_tiles(b, l, sms):
            assert 0 <= img < b and r0 % ROWS == 0 and r0 + ROWS <= l
            cover[img, r0:r0 + ROWS] += 1
            blocks.add(blk)
        assert torch.equal(cover, torch.ones_like(cover)), (h, w)
        assert len(blocks) == min(sms, b * l // ROWS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(9 * C, C), (C, 384), (128, 16)])
def test_pack_sw128_is_inverted_by_unpack(dtype, shape):
    w = torch.randn(*shape, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    p = fs.pack_sw128(w)
    assert p.shape == (shape[0] // 64 * shape[1], 64) and p.is_contiguous()
    assert torch.equal(torch.sort(p.flatten()).values,
                       torch.sort(w.flatten()).values)
    assert torch.equal(fs.unpack_sw128(p, shape[1]), w)
    # row n of a block holds column n of w, each 16-byte chunk j of k at
    # chunk j ^ (n % 8)
    n, k = 5, 19
    assert p[n, (((k // 8) ^ (n % 8)) * 8 + k % 8)] == w[k, n]


def _block(seed: int) -> TransformerResidualBlock:
    torch.manual_seed(seed)
    blk = TransformerResidualBlock(C, fused_srb=True)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.75, 1.25)
            bn.weight.normal_(1, 0.1)
            bn.bias.normal_(0, 0.1)
    return blk.eval()


def test_packed_operands_unpack_to_the_folded_weights():
    blk = _block(2)
    ops = blk.srb_operands(8, 64, torch.bfloat16, torch.device("cpu"))
    for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2)):
        name = "conv1" if conv is blk.conv1 else "conv2"
        oihw, _ = fs.fold_bn(conv.weight, conv.bias, {
            "scale": bn.weight, "bias": bn.bias, "mean": bn.running_mean,
            "var": bn.running_var}, bn.eps)
        w576 = fs.unpack_sw128(ops[f"{name}_wg"], C)
        assert torch.equal(w576, ops[f"{name}_w"])
        assert torch.equal(w576.reshape(3, 3, C, C).permute(3, 2, 0, 1),
                           oihw.to(torch.bfloat16))
    assert torch.equal(fs.unpack_sw128(ops["wtop_wg"], 384), ops["wtop"])
    fp32 = blk.srb_operands(8, 64, torch.float32, torch.device("cpu"))
    assert not set(fs.PACKED_OPERANDS) & set(fp32)


def test_packed_operands_follow_the_enhancer():
    """The packed wtop is cached with the folded convs: an update of the
    enhancer's weights must reach it."""
    blk = _block(3)
    cpu = torch.device("cpu")
    before = blk.srb_operands(8, 64, torch.bfloat16, cpu)["wtop_wg"]
    assert blk.srb_operands(8, 64, torch.bfloat16, cpu)["wtop_wg"] is before
    with torch.no_grad():
        for p in blk.feature_enhancer.parameters():
            p.add_(0.01)
    ops = blk.srb_operands(8, 64, torch.bfloat16, cpu)
    assert not torch.equal(ops["wtop_wg"], before)
    assert torch.equal(fs.unpack_sw128(ops["wtop_wg"], 384), ops["wtop"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_qkv_reference_is_the_conv_then_the_qkv_stage(dtype):
    blk = _block(4)
    ops = blk.srb_operands(8, 64, dtype, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    r1 = (0.5 * torch.randn(2, 8, 64, C, generator=gen)).to(dtype)
    r, qkv = fs.srb_conv_qkv_reference(r1, ops)
    want_r = fs._conv_reference(r1, ops["conv2_w"], ops["conv2_b"]).to(dtype)
    want_qkv = _dense(want_r.reshape(2, 512, C), ops["wtop"],
                      ops["peqkv"]).to(dtype)
    assert r.dtype == qkv.dtype == dtype and qkv.shape == (2, 512, 384)
    assert torch.equal(r, want_r) and torch.equal(qkv, want_qkv)
    r1_want = fs._conv_reference(r1, ops["conv1_w"], ops["conv1_b"])
    assert torch.equal(fs.srb_conv_mish_reference(r1, ops), (
        r1_want * torch.tanh(torch.nn.functional.softplus(r1_want))
    ).to(dtype))
