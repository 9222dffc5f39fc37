"""EncoderDecoder segmentors and sliding-window inference (port of
fudanocr_tpu/models/seg/encoder_decoder.py:24-41, :69-86 and :115-168;
reference mmseg/models/segmentors/encoder_decoder.py:14-337).

`EncoderDecoder(img)` maps an NHWC image batch to NHWC per-pixel class
logits at the input size (backbone -> decode head at 1/4 -> bilinear
upsampling). `DetGuidedEncoderDecoder(img, det_gt=None)` (the reference's
EncoderDecoder_V4, over `CascadeMiTDetGuided`) returns those logits and
the backbone's NHWC det logits at 1/4. Both take `train=True, generator=g`
for the training forward (batch statistics, drop-path and dropout drawn
from g), which returns the same outputs. `slide_inference` runs a segmentor
over the same crop grid as the JAX
package: crops of `crop` every `stride`, the last row and column clamped
to the border, several crops batched into one forward (at most
`max_fwd_images` images), logits summed where crops overlap and divided by
the count map.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fudanocr_tpu_torch.models.seg.cascade_mit import upsample


def nchw(img: torch.Tensor) -> torch.Tensor:
    """NHWC -> a contiguous NCHW copy. Not the channels-last view: on the
    CPU, torch 2.13's backward of a 1x1 stride-2 convolution (the ResNet
    shortcuts) over a channels-last input corrupts the heap."""
    return img.permute(0, 3, 1, 2).contiguous()


class EncoderDecoder(nn.Module):
    """Backbone + decode head, keys `backbone.*` and `decode_head.*`."""

    def __init__(self, backbone: nn.Module, decode_head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) image -> (B, H, W, num_classes) logits."""
        x = nchw(img)
        feats = self.backbone(x, train, generator)
        logits = upsample(self.decode_head(feats, train, generator), x)
        return logits.permute(0, 2, 3, 1)


class DetGuidedEncoderDecoder(EncoderDecoder):
    """Det-guided backbone + decode head: (logits (B, H, W, classes),
    det logits (B, H/4, W/4, 2)), both NHWC. `det_gt` (B, H, W) {0, 1}
    replaces the predicted text map in the attention masks."""

    def forward(self, img: torch.Tensor,
                det_gt: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = nchw(img)
        feats, det_logits = self.backbone(x, det_gt, train, generator)
        logits = upsample(self.decode_head(feats, train, generator), x)
        return logits.permute(0, 2, 3, 1), det_logits.permute(0, 2, 3, 1)


def crop_grid(h: int, w: int, crop: Tuple[int, int],
              stride: Tuple[int, int]) -> Tuple[int, int, list]:
    """(crop h, crop w, [(y1, x1), ...]) of the sliding window over an
    h x w image, as encoder_decoder.py:136-141: crops no larger than the
    image, the last row and column moved back to end at the border."""
    ch, cw = min(crop[0], h), min(crop[1], w)
    sh, sw = stride
    h_grids = max((h - ch + sh - 1) // sh, 0) + 1
    w_grids = max((w - cw + sw - 1) // sw, 0) + 1
    return ch, cw, [(min(i * sh, h - ch), min(j * sw, w - cw))
                    for i in range(h_grids) for j in range(w_grids)]


def slide_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                    img: torch.Tensor, crop: Tuple[int, int],
                    stride: Tuple[int, int],
                    max_fwd_images: int = 16) -> torch.Tensor:
    """`apply_fn(crops) -> (n, ch, cw, C)` logits over an NHWC `img`
    (B, H, W, 3) -> (B, H, W, C) float32 logits: the crops of the grid in
    row-major order, `max(1, max_fwd_images // B)` crops per forward,
    summed into place and divided by how many crops cover each pixel."""
    b, h, w, _ = img.shape
    ch, cw, positions = crop_grid(h, w, crop, stride)
    per_pass = max(1, max_fwd_images // b)
    preds = None
    for g0 in range(0, len(positions), per_pass):
        group = positions[g0:g0 + per_pass]
        logits = apply_fn(torch.cat([img[:, y:y + ch, x:x + cw]
                                     for y, x in group])).float()
        if preds is None:
            preds = torch.zeros((b, h, w, logits.shape[-1]),
                                dtype=torch.float32, device=img.device)
        for g, (y, x) in enumerate(group):
            preds[:, y:y + ch, x:x + cw] += logits[g * b:(g + 1) * b]
    # the count map depends only on the grid: a host constant
    count = np.zeros((1, h, w, 1), np.float32)
    for y, x in positions:
        count[:, y:y + ch, x:x + cw] += 1.0
    return preds / torch.from_numpy(np.maximum(count, 1.0)).to(img.device)
