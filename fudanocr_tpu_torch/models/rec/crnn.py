"""CRNN, the CTC recognizer used to score SR outputs (port of
fudanocr_tpu/models/rec/crnn.py; reference
scene-text-telescope/model/crnn/crnn.py:25-80).

Seven convs with asymmetric pooling collapse a 32-high image to a 1-high,
W/4+1-wide feature sequence; two stacked BiLSTMs emit per-column class
logits (blank + 36). The reference runs it as `CRNN(32, 1, 37, 256)` on
gray input made by `parse_crnn_input`. Module names are the reference's
(`cnn.conv{i}`, `cnn.batchnorm{i}`, `rnn.{0,1}.rnn`, `rnn.{0,1}.embedding`).
Input NHWC, output (B, T, C) batch-major, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from fudanocr_tpu_torch.nn.layers import batch_norm, conv2d, linear
from fudanocr_tpu_torch.nn.recurrent import BiLSTM
from fudanocr_tpu_torch.ops.resize import resize_bicubic_torch

# ITU-R BT.601 luma weights (interfaces/base.py:319-325 parse_crnn_data)
_LUMA = (0.299, 0.587, 0.114)


def parse_crnn_input(imgs: torch.Tensor, hw=(32, 100)) -> torch.Tensor:
    """Bicubic resize to 32x100, then RGB -> gray as 0.299R + 0.587G +
    0.114B. (B, H, W, C>=3) NHWC in [0, 1] -> (B, 32, 100, 1) float32."""
    x = resize_bicubic_torch(imgs[..., :3].float(), hw)
    r, g, b = _LUMA
    return r * x[..., 0:1] + g * x[..., 1:2] + b * x[..., 2:3]


class BidirectionalLSTM(nn.Module):
    """BiLSTM followed by a per-step linear (keys `rnn`, `embedding`)."""

    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.rnn = BiLSTM(n_in, hidden)
        self.embedding = nn.Linear(2 * hidden, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.embedding, self.rnn(x))


class CRNN(nn.Module):
    def __init__(self, num_classes: int = 37, hidden: int = 256,
                 in_channels: int = 1, leaky_relu: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        feats = (64, 128, 256, 256, 512, 512, 512)
        with_bn = (False, False, True, False, True, False, True)
        self.cnn = nn.Sequential()
        for i in range(7):
            k, p = (2, 0) if i == 6 else (3, 1)
            self.cnn.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else feats[i - 1], feats[i], k, 1, p))
            if with_bn[i]:
                self.cnn.add_module(f"batchnorm{i}", nn.BatchNorm2d(feats[i]))
            self.cnn.add_module(f"relu{i}", nn.LeakyReLU(0.2) if leaky_relu
                                else nn.ReLU())
            if i in (0, 1):
                self.cnn.add_module(f"pooling{i}", nn.MaxPool2d(2, 2))
            elif i in (3, 5):
                # (2,2) window, (2,1) stride, width padded by 1 both sides
                self.cnn.add_module(f"pooling{(i + 1) // 2}",
                                    nn.MaxPool2d((2, 2), (2, 1), (0, 1)))
        self.rnn = nn.Sequential(BidirectionalLSTM(512, hidden, hidden),
                                 BidirectionalLSTM(hidden, hidden,
                                                   num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) with H a multiple of 16 -> (B, T, num_classes)
        logits at the model's compute dtype."""
        if x.shape[1] % 16:
            raise ValueError(f"input height must be a multiple of 16, got "
                             f"{x.shape[1]}")
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for m in self.cnn:
            if isinstance(m, nn.Conv2d):
                x = conv2d(m, x)
            elif isinstance(m, nn.BatchNorm2d):
                x = batch_norm(m, x)
            else:
                x = m(x)
        b, c, h, w = x.shape
        if h != 1:
            raise ValueError(f"conv feature height must be 1, got {h}")
        return self.rnn(x[:, :, 0].transpose(1, 2))
