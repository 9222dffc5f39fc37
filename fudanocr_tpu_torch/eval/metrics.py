"""Image and recognition metrics (port of fudanocr_tpu/eval/metrics.py,
which imports jax; reference scene-text-telescope/utils/ssim_psnr.py:9-135
and utils/util.py:12-24).

PSNR on [0, 1] images scaled x255 against their MSE; SSIM with an 11x11
Gaussian window (sigma 1.5) applied per channel as one depthwise
convolution, C1/C2 from K1 = 0.01 / K2 = 0.03, L = 1. Images are NHWC.
"""

from __future__ import annotations

import string

import numpy as np
import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.core.mesh import batch_mean
from fudanocr_tpu_torch.nn.layers import at_least_f32


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio over [0, 1] images (any shape); in a
    data-parallel step over the global batch (`core/mesh.batch_mean`)."""
    mse = batch_mean((img1 * 255.0 - img2 * 255.0) ** 2)
    return 20.0 * torch.log10(255.0 / mse.sqrt())


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over NHWC [0, 1] images (Gaussian window, per channel);
    in a data-parallel step over the global batch."""
    c = img1.shape[-1]
    w = torch.from_numpy(_gaussian_window(window_size)).to(img1.device)
    kernel = w[None, None].expand(c, 1, window_size, window_size)

    def filt(x):
        return F.conv2d(x, kernel.to(x.dtype), padding=window_size // 2,
                        groups=c)

    a = at_least_f32(img1).permute(0, 3, 1, 2)
    b = at_least_f32(img2).permute(0, 3, 1, 2)
    mu1, mu2 = filt(a), filt(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(a * a) - mu1_sq
    sigma2_sq = filt(b * b) - mu2_sq
    sigma12 = filt(a * b) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return batch_mean(ssim_map)


def str_filt(s: str, voc_type: str = "lower") -> str:
    """Vocabulary filtering: keep only chars in the vocabulary, lowercase
    the result."""
    alpha_dict = {
        "digit": string.digits,
        "lower": string.digits + string.ascii_lowercase,
        "upper": string.digits + string.ascii_letters,
        "all": string.digits + string.ascii_letters + string.punctuation,
    }
    if voc_type == "lower":
        s = s.lower()
    s = "".join(ch for ch in s if ch in alpha_dict[voc_type])
    return s.lower()


def sequence_hits(preds: list, gts: list, voc_type: str = "lower") -> int:
    """Exact matches after vocabulary filtering."""
    return sum(1 for p, g in zip(preds, gts)
               if str_filt(p, voc_type) == str_filt(g, voc_type))


def sequence_accuracy(preds: list, gts: list, voc_type: str = "lower") -> float:
    """Exact-match accuracy after vocabulary filtering."""
    if not gts:
        return 0.0
    return sequence_hits(preds, gts, voc_type) / len(gts)
