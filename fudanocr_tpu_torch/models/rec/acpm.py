"""ACPM, augmented character profile matching (ACM MM-22) (port of
fudanocr_tpu/models/rec/acpm.py; reference character-profile-matching/
model/transformer.py:306-567, densenet.py, vgg.py).

One encoder feeds the radical decoder (the CTR core's embedding beside a
1-D positional code, one `OCRDecoderLayer`, the generator) and two
profile heads on its conv features:

* `RadicalCounter` (`RSC_R`): three conv+BN+ReLU stages (1024 -> 512 ->
  256 -> 64), a global mean pool, a linear layer to a scalar (L1 mode) or
  to an 11-way softmax (CE mode: the loss takes log(max(p, 1e-8)), as
  JAX does);
* `StrokeCounter` (`RSC_S`): a shared CNN (1024 -> 512 -> 256 -> 128)
  feeding an N head (mean pool, 4 orientation counts) and an L head (two
  more convs, mean pool, 4 orientation lengths).

The encoder is the OCR ResNet with the stem pool only (`encoder="resnet"`,
the reference's), JAX's VGG stack or its compact DenseNet. `stn=True`
puts an STN head (20 control points) and a TPS warp to 32x32 (margins
0.05) in front, as JAX does (the STN's flatten order is JAX's, ROADMAP
C6).

Module names are the reference state_dict's where it has one
(`encoder.conv1`, `encoder.layer{s}.{i}...`, `embedding_word.lut`,
`decoder.mask_multihead...`, `generator_word.proj`,
`RSC_R.conv{1..3}/bn{1..3}/linear`, `RSC_S.shared_CNN.conv{1..3}/bn{1..3}`,
`RSC_S.count_n.linear`, `RSC_S.count_l.conv{1,2}/bn{1,2}/linear`,
`stn_head.*`), which `utils/porters.port_acpm` reads. JAX's VGG and
DenseNet encoders have no reference layout; their keys mirror the JAX
names (`encoder.block{i}.{0,1}`, `encoder.stem`, `encoder.b{b}l{i}_conv1`,
`encoder.trans{b}`, `encoder.head_bn`, ...).

Images are NHWC at the public functions, NCHW inside. `dtype` is the
compute dtype (parameters stay float32), `kernels=False` runs the decoder
LayerNorms' plain version (the comparison path).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.models.rec.ocr_transformer import (
    OCRDecoderLayer, OCRResNet, TokenDecoding, _Embeddings, _Generator)
from fudanocr_tpu_torch.nn.layers import (ConvBNReLU, batch_norm, conv2d,
                                          linear, max_pool)
from fudanocr_tpu_torch.nn.stn import STNHead
from fudanocr_tpu_torch.nn.tps import TPSSpatialTransformer

ENCODER_FEATURES = 1024   # the VGG and DenseNet encoders' output width


def _conv_bn_relu(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor,
                  train: bool) -> torch.Tensor:
    return F.relu(batch_norm(bn, conv2d(conv, x), train))


class VGGEncoder(nn.Module):
    """character-profile-matching/model/vgg.py:4-60: twelve conv3x3 + BN +
    ReLU blocks (`block{i}`), 2x2 max pools after blocks 0 and 1, 1024
    channels out."""

    PLAN = ((64, True), (64, True), (128, False), (128, False), (256, False),
            (256, False), (512, False), (512, False), (512, False),
            (512, False), (512, False), (1024, False))

    def __init__(self, num_in: int = 3):
        super().__init__()
        cin = num_in
        for i, (f, _) in enumerate(self.PLAN):
            setattr(self, f"block{i}", ConvBNReLU(cin, f))
            cin = f
        self.out_features = cin

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i, (_, pool) in enumerate(self.PLAN):
            x = getattr(self, f"block{i}")(x, train)
            if pool:
                x = max_pool(x, 2)
        return x


class DenseNetEncoder(nn.Module):
    """JAX's compact DenseNet (densenet.py:54-107 shape): a 3x3 stem + BN
    + ReLU + pool, dense blocks of BN-ReLU'd 1x1 (4 x growth) and 3x3
    (growth) convs whose outputs are concatenated, a 1x1 transition to half
    the channels + pool between blocks, and a 3x3 1024 head + BN + ReLU."""

    def __init__(self, num_in: int = 3, growth: int = 32,
                 block_config: Sequence[int] = (4, 8, 8)):
        super().__init__()
        self.block_config = tuple(block_config)
        self.stem = nn.Conv2d(num_in, 64, 3, padding=1)
        self.stem_bn = nn.BatchNorm2d(64)
        c = 64
        for b, n_layers in enumerate(self.block_config):
            for i in range(n_layers):
                setattr(self, f"b{b}l{i}_conv1", nn.Conv2d(c, 4 * growth, 1))
                setattr(self, f"b{b}l{i}_bn1", nn.BatchNorm2d(4 * growth))
                setattr(self, f"b{b}l{i}_conv2",
                        nn.Conv2d(4 * growth, growth, 3, padding=1))
                setattr(self, f"b{b}l{i}_bn2", nn.BatchNorm2d(growth))
                c += growth
            if b < len(self.block_config) - 1:
                setattr(self, f"trans{b}", nn.Conv2d(c, c // 2, 1))
                c //= 2
        self.head = nn.Conv2d(c, ENCODER_FEATURES, 3, padding=1)
        self.head_bn = nn.BatchNorm2d(ENCODER_FEATURES)
        self.out_features = ENCODER_FEATURES

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = max_pool(_conv_bn_relu(self.stem, self.stem_bn, x, train), 2)
        for b, n_layers in enumerate(self.block_config):
            for i in range(n_layers):
                m = lambda n: getattr(self, f"b{b}l{i}_{n}")
                h = _conv_bn_relu(m("conv1"), m("bn1"), x, train)
                h = _conv_bn_relu(m("conv2"), m("bn2"), h, train)
                x = torch.cat([x, h], 1)
            if b < len(self.block_config) - 1:
                x = max_pool(conv2d(getattr(self, f"trans{b}"), x), 2)
        return _conv_bn_relu(self.head, self.head_bn, x, train)


class _ConvStack(nn.Module):
    """`conv{i}` / `bn{i}` pairs from 1 (the reference's counters), each a
    3x3 conv + BN + ReLU; `linear` after a global mean pool when
    `out` is given."""

    def __init__(self, cin: int, widths: Sequence[int],
                 out: Optional[int] = None):
        super().__init__()
        self.depth = len(widths)
        for i, f in enumerate(widths):
            setattr(self, f"conv{i + 1}", nn.Conv2d(cin, f, 3, padding=1))
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(f))
            cin = f
        self.out_features = cin
        if out is not None:
            self.linear = nn.Linear(cin, out)

    def convs(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(1, self.depth + 1):
            x = _conv_bn_relu(getattr(self, f"conv{i}"),
                              getattr(self, f"bn{i}"), x, train)
        return x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return linear(self.linear, self.convs(x, train).mean((2, 3)))


def _widths(widths: Sequence[int], width_div: int) -> Tuple[int, ...]:
    return tuple(max(f // width_div, 4) for f in widths)


class RadicalCounter(_ConvStack):
    """The radical count: a scalar (`rn_loss="L1"`) or an 11-way softmax
    (`"CE"`). `width_div` divides the widths (small test models)."""

    def __init__(self, cin: int, rn_loss: str = "L1", width_div: int = 1):
        if rn_loss not in ("L1", "CE"):
            raise ValueError(f"rn_loss must be 'L1' or 'CE', got {rn_loss!r}")
        super().__init__(cin, _widths((512, 256, 64), width_div),
                         1 if rn_loss == "L1" else 11)
        self.rn_loss = rn_loss

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = super().forward(x, train)
        return y[:, 0] if self.rn_loss == "L1" else y.softmax(-1)


class _Linear(nn.Module):
    """The reference's `count_n.linear` nesting."""

    def __init__(self, cin: int, out: int):
        super().__init__()
        self.linear = nn.Linear(cin, out)


class StrokeCounter(nn.Module):
    """-> (4 orientation counts, 4 orientation lengths) per image."""

    def __init__(self, cin: int, width_div: int = 1):
        super().__init__()
        self.shared_CNN = _ConvStack(cin, _widths((512, 256, 128), width_div))
        c = self.shared_CNN.out_features
        self.count_n = _Linear(c, 4)
        self.count_l = _ConvStack(c, _widths((64, 32), width_div), 4)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.shared_CNN.convs(x, train)
        return (linear(self.count_n.linear, x.mean((2, 3))),
                self.count_l(x, train))


class ACPM(TokenDecoding):
    """The ACPM recogniser and profile heads (see the module docstring).
    `encoder_layers` overrides the ResNet's blocks per stage (reference
    (3, 4, 6, 3)); `encoder_width_div` divides the ResNet's and the
    counters' widths (small test models only)."""

    def __init__(self, vocab: int, encoder: str = "resnet",
                 rn_loss: str = "L1", stn: bool = False, num_heads: int = 4,
                 d_model: int = 1024,
                 encoder_layers: Optional[Sequence[int]] = None,
                 encoder_width_div: int = 1, kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder == "resnet":
            self.encoder = OCRResNet(
                3, tuple(encoder_layers or (3, 4, 6, 3)),
                stage_pools=(False,) * 4, width_div=encoder_width_div)
        elif encoder == "densenet":
            self.encoder = DenseNetEncoder()
        elif encoder == "vgg":
            self.encoder = VGGEncoder()
        else:
            raise ValueError(f"encoder must be resnet, densenet or vgg, got "
                             f"{encoder!r}")
        self.stn, self.d_embed, self.dtype = stn, d_model // 2, dtype
        if stn:
            self.stn_head = STNHead(3, num_ctrlpoints=20)
            self.tps = TPSSpatialTransformer((32, 32), 20, (0.05, 0.05))
        mem = self.encoder.out_features
        self.embedding_word = _Embeddings(vocab, self.d_embed)
        self.decoder = OCRDecoderLayer(
            num_heads, d_model, 2 * d_model,
            memory_features=None if mem == d_model else mem, kernels=kernels)
        self.generator_word = _Generator(d_model, vocab)
        self.RSC_R = RadicalCounter(mem, rn_loss, encoder_width_div)
        self.RSC_S = StrokeCounter(mem, encoder_width_div)

    def rectify(self, image: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """NHWC image -> the TPS-rectified 32x32 image (the image itself
        without an STN)."""
        if not self.stn:
            return image
        _, ctrl = self.stn_head(image.permute(0, 3, 1, 2).to(self.dtype),
                                train)
        return self.tps(image, ctrl)[0]

    def _conv(self, image: torch.Tensor, train: bool) -> torch.Tensor:
        image = self.rectify(image, train)
        return self.encoder(image.permute(0, 3, 1, 2).to(self.dtype)
                            .contiguous(), train)

    def encode(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NHWC image -> (B, Ht*Wt, C) memory tokens."""
        return self._conv(image, train).flatten(2).transpose(1, 2)

    def forward(self, image: torch.Tensor, text_input: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: the decoder's outputs (`pred`, `map`,
        `hidden`), the memory (`conv`) and the profile heads' (`r_num`,
        `s_num`, `s_len`)."""
        conv = self._conv(image, train)
        memory = conv.flatten(2).transpose(1, 2)
        pred, attn_map, hidden = self.decode_step(memory, text_input, train,
                                                  generator=generator)
        s_num, s_len = self.RSC_S(conv, train)
        return {"pred": pred, "map": attn_map, "conv": memory,
                "hidden": hidden, "r_num": self.RSC_R(conv, train),
                "s_num": s_num, "s_len": s_len}
