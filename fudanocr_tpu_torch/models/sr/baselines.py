"""The SR baseline generators and the SRGAN discriminator (port of
fudanocr_tpu/models/sr/baselines.py; reference scene-text-telescope/
model/{srcnn.py:18-53, srresnet.py:14-145, edsr.py:35-88, rdn.py:54-93}
and text-gestalt/model/esrgan.py:55-87).

The reference trains these as comparison baselines with the same trainer
as TBSRN (`--arch srcnn|srresnet|edsr|rdn|esrgan`). The JAX module's
quirks are kept:

* SRCNN upsamples first (nearest) and then convolves (srcnn.py:47);
* EDSR subtracts the DIV2K RGB means before its trunk, adds them back at
  the end, and scales each residual branch by 0.1; its convolutions have
  no bias;
* RRDBNet upsamples by a nearest resize and a conv, not by PixelShuffle;
* SRCNN's and SRResNet's input (and output) take 4 planes with `mask`.

Input and output are NHWC, as for TBSRN and TSRN (`models/sr/common.py`);
the convolutions run on an NCHW view. `forward(x, train=False,
generator=None)` is the SR trainer's signature: `train=True` runs the
BatchNorms of SRResNet and the discriminator on batch statistics and
moves their running ones as flax does (`nn/layers.batch_norm`); nothing
here draws, so `generator` is unused. No JAX kernel runs in these models:
their convolutions are plain XLA in JAX and cuDNN here.

Module names follow the reference's state_dicts, which the porters of
`utils/porters.py` read (`jax_porter` names each model's porter):
SRCNN `conv1-3`; SRResNet `block1` (conv, PReLU), `block2`-`block6`
(`conv1 bn1 prelu conv2 bn2`), `block7` (conv, BN), `block8` (`{u}.conv`,
`{u}.prelu`, then the output conv); EDSR `sub_mean`, `conv_input`,
`residual.{i}.conv1/conv2`, `conv_mid`, `upscale4x.{2u}`, `conv_output`,
`add_mean` (the mean shifts are the reference's frozen 1x1 convs with an
identity weight: buffers here, which no porter reads); RDN `conv1`,
`conv2`, `RDB{k}.dense_layers.{i}.conv`, `RDB{k}.conv_1x1`, `GFF_1x1`,
`GFF_3x3`, `conv_up`, `conv3`; RRDBNet `conv_first`,
`RRDB_trunk.{i}.RDB{j}.conv{1-5}`, `trunk_conv`, `upconv{u}`, `HRconv`,
`conv_last`; the discriminator `net.{i}` of its nn.Sequential. No
reference `.pth` of these models is in the repository, so the layout is
held only against the JAX package's trees (tests/test_torch_sr_baselines.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.models.sr.common import ConvBN
from fudanocr_tpu_torch.nn.layers import PReLU, batch_norm, conv2d

DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _n_up(scale_factor: int) -> int:
    if not math.log2(scale_factor).is_integer():
        raise ValueError(f"scale_factor must be a power of 2, got "
                         f"{scale_factor}")
    return int(math.log2(scale_factor))


def _nearest_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """NCHW nearest resize by an integer factor (jax.image.resize
    "nearest": each pixel repeated s times)."""
    return F.interpolate(x, scale_factor=s, mode="nearest")


class SRCNN(nn.Module):
    def __init__(self, scale_factor: int = 2, in_planes: int = 3):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv1 = nn.Conv2d(in_planes, 64, 9, padding=4)
        self.conv2 = nn.Conv2d(64, 32, 1)
        self.conv3 = nn.Conv2d(32, in_planes, 5, padding=2)
        self.jax_porter = ("srcnn", {})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _nearest_up(_nchw(x), self.scale_factor)
        x = F.relu(conv2d(self.conv1, x))
        x = F.relu(conv2d(self.conv2, x))
        return _nhwc(conv2d(self.conv3, x))


class SRResidualBlock(nn.Module):
    """conv-BN-PReLU-conv-BN plus the input (srresnet.py ResidualBlock)."""

    def __init__(self, features: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(features)
        self.prelu = PReLU()
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        r = self.prelu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        return x + batch_norm(self.bn2, conv2d(self.conv2, r), train)


class PReLUUpsample(nn.Module):
    """conv3x3 to 4C -> pixel shuffle x2 -> PReLU (srresnet.py
    UpsampleBLock: keys `conv`, `prelu`)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv = nn.Conv2d(features, features * 4, 3, padding=1)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(F.pixel_shuffle(conv2d(self.conv, x), 2))


class SRResNet(nn.Module):
    def __init__(self, scale_factor: int = 2, mask: bool = False):
        super().__init__()
        in_planes = 4 if mask else 3
        n_up = _n_up(scale_factor)
        self.block1 = nn.Sequential(nn.Conv2d(in_planes, 64, 9, padding=4),
                                    PReLU())
        for i in range(5):
            setattr(self, f"block{i + 2}", SRResidualBlock(64))
        self.block7 = ConvBN(64)
        self.block8 = nn.Sequential(
            *[PReLUUpsample(64) for _ in range(n_up)],
            nn.Conv2d(64, in_planes, 9, padding=4))
        self.jax_porter = ("srresnet", {})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        stem = self.block1[1](conv2d(self.block1[0], _nchw(x)))
        h = stem
        for i in range(5):
            h = getattr(self, f"block{i + 2}")(h, train)
        h = stem + self.block7(h, train)
        for up in self.block8[:-1]:
            h = up(h)
        return _nhwc(torch.tanh(conv2d(self.block8[-1], h)))


class MeanShift(nn.Module):
    """The reference's frozen 1x1 conv with an identity weight and the
    signed RGB means as its bias: adds `bias` per channel. Buffers, so the
    keys are in the state_dict and nothing trains them."""

    def __init__(self, sign: float):
        super().__init__()
        self.register_buffer("weight", torch.eye(3).view(3, 3, 1, 1))
        self.register_buffer("bias", sign * torch.tensor(DIV2K_RGB_MEAN))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias.to(x.dtype).view(1, 3, 1, 1)


class EDSRBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = conv2d(self.conv2, F.relu(conv2d(self.conv1, x)))
        return x + r * 0.1


class EDSR(nn.Module):
    def __init__(self, scale_factor: int = 2, num_blocks: int = 32,
                 features: int = 256):
        super().__init__()
        n_up = _n_up(scale_factor)
        conv = lambda i, o: nn.Conv2d(i, o, 3, padding=1, bias=False)
        self.sub_mean = MeanShift(-1.0)
        self.conv_input = conv(3, features)
        self.residual = nn.Sequential(*[EDSRBlock(features)
                                        for _ in range(num_blocks)])
        self.conv_mid = conv(features, features)
        ups = []
        for _ in range(n_up):
            ups += [conv(features, features * 4), nn.PixelShuffle(2)]
        self.upscale4x = nn.Sequential(*ups)
        self.conv_output = conv(features, 3)
        self.add_mean = MeanShift(1.0)
        self.jax_porter = ("edsr", {})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = conv2d(self.conv_input, self.sub_mean(_nchw(x)))
        res = h
        for block in self.residual:
            h = block(h)
        h = res + conv2d(self.conv_mid, h)
        for i in range(0, len(self.upscale4x), 2):
            h = F.pixel_shuffle(conv2d(self.upscale4x[i], h), 2)
        return _nhwc(self.add_mean(conv2d(self.conv_output, h)))


class DenseLayer(nn.Module):
    """relu(conv3x3 without bias), concatenated to its input (rdn.py
    make_dense: key `conv`)."""

    def __init__(self, channels: int, growth: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, F.relu(conv2d(self.conv, x))], 1)


class RDB(nn.Module):
    """Residual dense block (rdn.py RDB): dense layers, a 1x1 fuse without
    bias, plus the input."""

    def __init__(self, features: int = 64, num_dense: int = 6,
                 growth: int = 32):
        super().__init__()
        self.dense_layers = nn.Sequential(*[
            DenseLayer(features + i * growth, growth)
            for i in range(num_dense)])
        self.conv_1x1 = nn.Conv2d(features + num_dense * growth, features, 1,
                                  bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.conv_1x1, self.dense_layers(x)) + x


class RDN(nn.Module):
    def __init__(self, scale_factor: int = 2, features: int = 64,
                 num_dense: int = 6, growth: int = 32):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv1 = nn.Conv2d(3, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.RDB1, self.RDB2, self.RDB3 = (RDB(features, num_dense, growth)
                                           for _ in range(3))
        self.GFF_1x1 = nn.Conv2d(3 * features, features, 1)
        self.GFF_3x3 = nn.Conv2d(features, features, 3, padding=1)
        self.conv_up = nn.Conv2d(features, features * scale_factor ** 2, 3,
                                 padding=1)
        self.conv3 = nn.Conv2d(features, 3, 3, padding=1)
        self.jax_porter = ("rdn", {})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        f_m1 = conv2d(self.conv1, _nchw(x))
        f1 = self.RDB1(conv2d(self.conv2, f_m1))
        f2 = self.RDB2(f1)
        f3 = self.RDB3(f2)
        h = conv2d(self.GFF_1x1, torch.cat([f1, f2, f3], 1))
        h = conv2d(self.GFF_3x3, h) + f_m1
        h = F.pixel_shuffle(conv2d(self.conv_up, h), self.scale_factor)
        return _nhwc(conv2d(self.conv3, h))


class RDB5C(nn.Module):
    """ESRGAN's residual dense block of five convs (esrgan.py
    ResidualDenseBlock_5C): leaky ReLU 0.2 after conv1-4, out * 0.2 + x."""

    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(nf + i * gc, gc, 3, padding=1))
        self.conv5 = nn.Conv2d(nf + 4 * gc, nf, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            y = conv2d(getattr(self, f"conv{i + 1}"), torch.cat(feats, 1))
            feats.append(F.leaky_relu(y, 0.2))
        return conv2d(self.conv5, torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.RDB1, self.RDB2, self.RDB3 = (RDB5C(nf, gc) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """The ESRGAN generator (text-gestalt/model/esrgan.py:55-87)."""

    def __init__(self, scale_factor: int = 2, nf: int = 64, nb: int = 23,
                 gc: int = 32, in_nc: int = 3, out_nc: int = 3):
        super().__init__()
        self.n_up = _n_up(scale_factor)
        self.conv_first = nn.Conv2d(in_nc, nf, 3, padding=1)
        self.RRDB_trunk = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = nn.Conv2d(nf, nf, 3, padding=1)
        for i in range(self.n_up):
            setattr(self, f"upconv{i + 1}", nn.Conv2d(nf, nf, 3, padding=1))
        self.HRconv = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv_last = nn.Conv2d(nf, out_nc, 3, padding=1)
        self.jax_porter = ("esrgan", {})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fea = conv2d(self.conv_first, _nchw(x))
        fea = fea + conv2d(self.trunk_conv, self.RRDB_trunk(fea))
        for i in range(self.n_up):
            fea = F.leaky_relu(conv2d(getattr(self, f"upconv{i + 1}"),
                                      _nearest_up(fea, 2)), 0.2)
        h = F.leaky_relu(conv2d(self.HRconv, fea), 0.2)
        return _nhwc(conv2d(self.conv_last, h))


# (features, stride) of the discriminator's eight 3x3 convs
DISC_CONVS = ((64, 1), (64, 2), (128, 1), (128, 2), (256, 1), (256, 2),
              (512, 1), (512, 2))


class SRDiscriminator(nn.Module):
    """The SRGAN discriminator (srresnet.py:104-145) as an nn.Sequential
    `net`: conv0, leaky ReLU, then (conv, BN, leaky ReLU) x 7, the global
    average pool, the 1x1 convs fc1 (1024) and fc2 (1). Returns the (B,)
    logits: the reference's final sigmoid is the losses' (JAX's module
    returns logits too)."""

    def __init__(self, in_planes: int = 3):
        super().__init__()
        layers, c = [], in_planes
        for i, (f, s) in enumerate(DISC_CONVS):
            layers.append(nn.Conv2d(c, f, 3, s, 1))
            if i > 0:
                layers.append(nn.BatchNorm2d(f))
            layers.append(nn.LeakyReLU(0.2))
            c = f
        layers += [nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, 1024, 1),
                   nn.LeakyReLU(0.2), nn.Conv2d(1024, 1, 1)]
        self.net = nn.Sequential(*layers)
        self.jax_porter = ("sr_discriminator", {})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = _nchw(x)
        for layer in self.net:
            if isinstance(layer, nn.Conv2d):
                h = conv2d(layer, h)
            elif isinstance(layer, nn.BatchNorm2d):
                h = batch_norm(layer, h, train)
            elif isinstance(layer, nn.AdaptiveAvgPool2d):
                h = h.mean(dim=(2, 3), keepdim=True)
            else:
                h = F.leaky_relu(h, 0.2)
        return h.reshape(h.shape[0])


def build_baseline(arch: str, scale_factor: int = 2, mask: bool = False,
                   **_) -> nn.Module:
    """One of the five baselines at JAX's default widths (other keyword
    arguments, the apps' width/height, are ignored as in JAX)."""
    if arch == "srcnn":
        return SRCNN(scale_factor=scale_factor, in_planes=4 if mask else 3)
    if arch == "srresnet":
        return SRResNet(scale_factor=scale_factor, mask=mask)
    if arch == "edsr":
        return EDSR(scale_factor=scale_factor)
    if arch == "rdn":
        return RDN(scale_factor=scale_factor)
    if arch == "esrgan":
        return RRDBNet(scale_factor=scale_factor)
    raise ValueError(f"unknown SR baseline {arch!r}")
