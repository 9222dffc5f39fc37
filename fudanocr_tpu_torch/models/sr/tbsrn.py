"""TBSRN, the transformer-based SR network (port of
fudanocr_tpu/models/sr/tbsrn.py; Scene Text Telescope, CVPR-21,
scene-text-telescope/model/tbsrn.py:166-226).

A 9x9 conv stem + PReLU, `srb_nums` residual blocks (conv-BN-mish-conv-BN
then the FeatureEnhancer), a conv+BN trunk tail with a global skip from the
stem, PixelShuffle upsampling, a 9x9 output conv and tanh.

`forward(x, train=True, generator=g)` is the training path of the JAX
module (tbsrn.py:122-150, 189-228): with `stn=True` the STN head predicts
TPS control points on the LR input and the TPS warp replaces it; every
BatchNorm runs on batch statistics (flax's running-statistics update);
each FeatureEnhancer runs unfused with dropout 0.1 on the attention
probabilities (hash dropout, one seed per call) and after the FFN's ReLU,
its two LayerNorms through the fused residual-LayerNorm op. At inference
the STN is not run, as in the JAX package, and each enhancer is one call
of the fused-enhancer kernel when `fused_enhancer` is on (JAX's flag,
tbsrn.py:176) and the token count passes JAX's `fused_enhancer_supported`;
otherwise it runs unfused, its attention through the `use_flash` route of
nn/attention.py (the packed-qkv kernel at 512 <= L <= 2048). With
`fused_srb` on (JAX's flag, tbsrn.py:180, off by default) each whole
residual block is one call of the whole-SRB kernels (ops/fused_srb.py,
BN folded into the convs) where the map passes JAX's `fused_srb_supported`;
the enhancer flag then does not matter for the blocks.

`kernels=False` runs the plain PyTorch version of every kernel of the
model instead (whole SRB, fused enhancer, residual LayerNorm, the attention
kernels), on any device and on the same routes: the path the kernels are
compared with.

Input and output are NHWC, as in the JAX package; the convolutions run on
an NCHW view of it (channels_last memory, which cuDNN takes directly and
which makes the (B, H*W, C) token view of every block a free reshape).
Module names follow the original state_dict (`block1.0`, `block{i+2}.*`,
`block{n+2}.0/1`, `block{n+3}.*`, `stn_head.*`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.models.sr.common import SRGenerator
from fudanocr_tpu_torch.nn.attention import (MultiHeadAttention,
                                             positional_encoding_2d)
from fudanocr_tpu_torch.nn.layers import (PositionwiseFeedForward,
                                          TorchLayerNorm, batch_norm, conv2d,
                                          dropout, linear, mish)
from fudanocr_tpu_torch.ops.fused_enhancer import (enhancer_operands,
                                                   fused_enhancer,
                                                   fused_enhancer_reference,
                                                   fused_enhancer_supported)
from fudanocr_tpu_torch.ops.fused_srb import (fused_srb, fused_srb_reference,
                                              fused_srb_supported,
                                              srb_operands)


class FeatureEnhancer(nn.Module):
    """Self-attention over the flattened feature tokens (tbsrn.py:63-92).

    (B, L, C=64) tokens get the 64-d 2D positional code appended -> 128-d,
    one MHA(4 heads) + FFN(128) block with the reference's std LayerNorm,
    then a projection back to 64. The positional code is made for the
    actual (h, w) of the feature map, as the JAX module does at trace time.
    At inference with `fused` on and an L that `fused_enhancer_supported`
    takes, the block runs through `ops.fused_enhancer.fused_enhancer` (the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors);
    `kernels=False` runs the plain version on any device. Otherwise, and
    in training, it runs unfused, as the JAX module does (tbsrn.py:65-96;
    the fused kernel has no backward), its MHA built with `use_flash`.
    """

    dropout_rate = 0.1   # after the FFN's ReLU (flax nn.Dropout(0.1))

    def __init__(self, kernels: bool = True, fused: bool = True):
        super().__init__()
        self.kernels, self.fused = kernels, fused
        self.multihead = MultiHeadAttention(num_heads=4, d_model=128,
                                            kernels=kernels, use_flash=True)
        self.mul_layernorm1 = TorchLayerNorm(128, kernels=kernels)
        self.pff = PositionwiseFeedForward(128, 128)
        self.mul_layernorm3 = TorchLayerNorm(128, kernels=kernels)
        self.linear = nn.Linear(128, 64)
        self._operands: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._pe: Dict[tuple, torch.Tensor] = {}

    def kernel_params(self) -> Dict[str, torch.Tensor]:
        """The weights in the (in, out) layout `enhancer_operands` takes."""
        lin = self.multihead.linears
        return {
            "wqkv": torch.cat([m.weight.t() for m in lin[:3]], dim=1),
            "bqkv": torch.cat([m.bias for m in lin[:3]]),
            "wout": lin[3].weight.t(), "bout": lin[3].bias,
            "ln1_scale": self.mul_layernorm1.a_2,
            "ln1_bias": self.mul_layernorm1.b_2,
            "w1": self.pff.w_1.weight.t(), "b1": self.pff.w_1.bias,
            "w2": self.pff.w_2.weight.t(), "b2": self.pff.w_2.bias,
            "ln2_scale": self.mul_layernorm3.a_2,
            "ln2_bias": self.mul_layernorm3.b_2,
            "wp": self.linear.weight.t(), "bp": self.linear.bias,
        }

    def operands(self, h: int, w: int, dtype: torch.dtype,
                 device: torch.device) -> Dict[str, torch.Tensor]:
        """Kernel operands for an (h, w) feature map, cached per geometry,
        dtype and device until a parameter changes (in-place updates such
        as load_state_dict bump the parameters' version counters).
        Parameters made under inference_mode have no version counter, so
        their operands are rebuilt on every call."""
        params = list(self.parameters())
        pe = positional_encoding_2d(64, h, w).reshape(64, h * w).T
        if any(p.is_inference() for p in params):
            return enhancer_operands(self.kernel_params(),
                                     torch.from_numpy(pe.copy()).to(device),
                                     dtype)
        key = (h, w, dtype, device,
               tuple((p.data_ptr(), p._version) for p in params))
        if key not in self._operands:
            self._operands = {k: v for k, v in self._operands.items()
                              if k[4] == key[4]}
            with torch.no_grad():
                self._operands[key] = enhancer_operands(
                    self.kernel_params(),
                    torch.from_numpy(pe.copy()).to(device), dtype)
        return self._operands[key]

    def forward(self, tokens: torch.Tensor, h: int, w: int,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L = h*w, 64) tokens of an (h, w) map -> (B, L, 64)."""
        if not train and self.fused and fused_enhancer_supported(h * w, 128,
                                                                  4):
            ops = self.operands(h, w, tokens.dtype, tokens.device)
            run = fused_enhancer if self.kernels else fused_enhancer_reference
            return run(tokens.contiguous(), ops, heads=4)
        return self._unfused(tokens, h, w, train, generator)

    def _unfused(self, tokens, h, w, train, generator):
        b, l, _ = tokens.shape
        key = (h, w, tokens.dtype, tokens.device,
               torch.is_inference_mode_enabled())
        if key not in self._pe:   # one host-to-device copy per geometry
            self._pe[key] = torch.from_numpy(positional_encoding_2d(
                64, h, w).reshape(64, l).T.copy()).to(tokens.device,
                                                       tokens.dtype)
        pe = self._pe[key]
        x = torch.cat([tokens, pe.expand(b, l, 64)], dim=-1)
        attn, _ = self.multihead(x, x, x, deterministic=not train,
                                 need_weights=False, generator=generator)
        x = self.mul_layernorm1(x, attn)
        y = F.relu(linear(self.pff.w_1, x))
        if train:
            y = dropout(y, self.dropout_rate, generator)
        x = self.mul_layernorm3(x, linear(self.pff.w_2, y))
        return linear(self.linear, x)


class TransformerResidualBlock(nn.Module):
    """conv-BN-mish-conv-BN then FeatureEnhancer, residual (the reference's
    RecurrentResidualBlock, tbsrn.py:229-257, without the two GRU blocks it
    builds and never calls).

    At inference with `fused_srb` on and a map that `fused_srb_supported`
    takes (JAX tbsrn.py:128-131), the whole block runs through
    `ops.fused_srb.fused_srb` (the CUDA kernels on CUDA tensors, the plain
    version on CPU tensors; `kernels=False`: the plain version on any
    device), on the NHWC view of the channels_last map. Training ignores
    the flag."""

    def __init__(self, channels: int, kernels: bool = True,
                 fused_enhancer: bool = True, fused_srb: bool = False):
        super().__init__()
        self.kernels, self.fused_srb = kernels, fused_srb
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels)
        self.feature_enhancer = FeatureEnhancer(kernels=kernels,
                                                fused=fused_enhancer)
        self._conv_ops: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def srb_operands(self, h: int, w: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
        """`fused_srb` operands for an (h, w) map: the enhancer's (cached by
        `FeatureEnhancer.operands`), the BN-folded conv weights and, in
        bf16, the bf16 kernels' packed conv weights and wtop, cached per
        dtype and device until a conv, BN or enhancer parameter or a BN
        running statistic changes (training moves the statistics in place,
        which bumps their version counters). Tensors made under
        inference_mode have no version counter: the fold is then redone
        every call."""
        convs = (self.conv1, self.bn1, self.conv2, self.bn2)
        state = [t for m in convs for t in (*m.parameters(), *m.buffers())]
        state += list(self.feature_enhancer.parameters())
        enh = self.feature_enhancer.operands(h, w, dtype, device)

        def fold():
            return srb_operands(
                (self.conv1.weight, self.conv1.bias), _bn(self.bn1),
                (self.conv2.weight, self.conv2.bias), _bn(self.bn2),
                {"wtop": enh["wtop"]}, dtype, self.bn1.eps)

        if any(t.is_inference() for t in state):
            return {**enh, **fold()}
        key = (dtype, device, tuple((t.data_ptr(), t._version)
                                    for t in state))
        if key not in self._conv_ops:
            self._conv_ops = {k: v for k, v in self._conv_ops.items()
                              if k[2] == key[2]}
            with torch.no_grad():
                self._conv_ops[key] = fold()
        return {**enh, **self._conv_ops[key]}

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        if not train and self.fused_srb and fused_srb_supported(h, w, c, 4):
            ops = self.srb_operands(h, w, x.dtype, x.device)
            run = fused_srb if self.kernels else fused_srb_reference
            return run(x.permute(0, 2, 3, 1).contiguous(), ops,
                       heads=4).permute(0, 3, 1, 2)
        r = mish(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        r = batch_norm(self.bn2, conv2d(self.conv2, r), train)
        b, c, h, w = r.shape
        tokens = r.permute(0, 2, 3, 1).reshape(b, h * w, c)
        tokens = self.feature_enhancer(tokens, h, w, train, generator)
        return x + tokens.view(b, h, w, c).permute(0, 3, 1, 2)


def _bn(m: nn.BatchNorm2d) -> Dict[str, torch.Tensor]:
    return {"scale": m.weight, "bias": m.bias, "mean": m.running_mean,
            "var": m.running_var}


class TBSRN(SRGenerator):
    """TBSRN on the shared trunk (`models/sr/common.SRGenerator`), its
    residual blocks `TransformerResidualBlock`s."""

    def __init__(self, scale_factor: int = 2, width: int = 128,
                 height: int = 32, stn: bool = True, srb_nums: int = 5,
                 mask: bool = False, hidden_units: int = 32,
                 kernels: bool = True, fused_enhancer: bool = True,
                 fused_srb: bool = False,
                 dtype: torch.dtype = torch.float32):
        if hidden_units != 32:
            raise ValueError("the FeatureEnhancer takes 64 trunk channels "
                             "(hidden_units=32), as the reference hardcodes")
        super().__init__(
            lambda feats: TransformerResidualBlock(
                feats, kernels=kernels, fused_enhancer=fused_enhancer,
                fused_srb=fused_srb),
            scale_factor, width, height, stn, srb_nums, mask, hidden_units,
            dtype)
        # the porter (utils/porters.py) and its arguments for this model
        self.jax_porter = ("tbsrn", dict(srb_nums=srb_nums,
                                         scale_factor=scale_factor, stn=stn))
