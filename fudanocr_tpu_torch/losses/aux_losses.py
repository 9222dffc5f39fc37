"""Auxiliary SR losses: gradient prior, total variation, perceptual, GAN
(port of fudanocr_tpu/losses/aux_losses.py; reference scene-text-telescope/
loss/{gradient_loss.py:10-37, percptual_loss.py:7-50} and the ESRGAN
adversarial objective of text-gestalt).

Images are NHWC, as the SR models give them. The perceptual loss runs a
VGG16 trunk up to relu5_3 (`VGG16Features`, torchvision's `features.{i}`
keys, which `utils/porters.port_vgg16_features` reads); no VGG16 weights
are in the repository and nothing is downloaded, so it runs on the
weights it is given, seeded random ones included, as the JAX package's
does. The GAN losses take the discriminator's logits.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.core.mesh import mean_share
from fudanocr_tpu_torch.nn.layers import conv2d


def gradient_prior_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """L1 between the spatial gradient-magnitude maps (gradient_loss.py:
    10-37): |x[w] - x[w+1]| and |x[h] - x[h+1]|, each zero-padded at its
    end, as sqrt(dh^2 + dv^2 + 1e-12)."""

    def gmap(img):
        dh = F.pad((img[:, :, :-1] - img[:, :, 1:]).abs(), (0, 0, 0, 1))
        dv = F.pad((img[:, :-1] - img[:, 1:]).abs(), (0, 0, 0, 0, 0, 1))
        return torch.sqrt(dh ** 2 + dv ** 2 + 1e-12)

    return (gmap(sr) - gmap(hr)).abs().mean()


def total_variation_loss(x: torch.Tensor) -> torch.Tensor:
    """The TV regulariser (percptual_loss.py:30-47): squared neighbour
    differences along H and W, each over its count, times 2 / batch."""
    b, h, w, c = x.shape
    dh = ((x[:, 1:] - x[:, :-1]) ** 2).sum()
    dw = ((x[:, :, 1:] - x[:, :, :-1]) ** 2).sum()
    return 2.0 * (dh / ((h - 1) * w * c) + dw / (h * (w - 1) * c)) / b


class VGG16Features(nn.Module):
    """VGG16's 13 convs with a ReLU after each and a 2x2 max pool after
    the first four of its five blocks (torchvision `vgg16().features`
    up to relu5_3, indices 0-29; the JAX module leaves out the reference
    slice's last pool too). NHWC in, NHWC features out."""

    def __init__(self):
        super().__init__()
        layers, c = [], 3
        for f, n in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
            for _ in range(n):
                layers += [nn.Conv2d(c, f, 3, padding=1), nn.ReLU()]
                c = f
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers[:-1])
        self.jax_porter = ("vgg16_features", {})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                h = F.relu(conv2d(layer, h))
            elif isinstance(layer, nn.MaxPool2d):
                h = F.max_pool2d(h, 2, 2)
        return h.permute(0, 2, 3, 1)


def perceptual_loss(vgg: Callable[[torch.Tensor], torch.Tensor],
                    sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """MSE in VGG feature space (percptual_loss.py:17-27); `vgg(img)` gives
    the features, and no gradient flows through the HR branch."""
    f_sr = vgg(sr)
    with torch.no_grad():
        f_hr = vgg(hr)
    return ((f_sr - f_hr) ** 2).mean()


def gan_generator_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """The non-saturating generator loss, mean softplus(-D(G(z))) (in a
    data-parallel step this rank's share of the global batch's mean)."""
    return mean_share(F.softplus(-fake_logits))


def gan_discriminator_loss(real_logits: torch.Tensor,
                           fake_logits: torch.Tensor) -> torch.Tensor:
    """The real/fake BCE on logits: softplus(-real) + softplus(fake)
    (shares of the global means, as `gan_generator_loss`)."""
    return (mean_share(F.softplus(-real_logits))
            + mean_share(F.softplus(fake_logits)))
