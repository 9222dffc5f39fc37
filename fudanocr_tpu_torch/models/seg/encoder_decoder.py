"""EncoderDecoder segmentors, sliding-window and test-time-augmented
inference (port of fudanocr_tpu/models/seg/encoder_decoder.py; reference
mmseg/models/segmentors/encoder_decoder.py:14-337, cascade_encoder_decoder.
py:12-98, pipelines/test_time_aug.py).

`EncoderDecoder(img)` maps an NHWC image batch to NHWC per-pixel class
logits at the input size (backbone -> decode head at 1/4 -> bilinear
upsampling). `DetGuidedEncoderDecoder(img, det_gt=None)` (the reference's
EncoderDecoder_V4, over `CascadeMiTDetGuided`) returns those logits and
the backbone's NHWC det logits at 1/4. `CascadeEncoderDecoder(img)` runs
a list of decode heads, each after the first taking the backbone's
features with the previous head's logits (resized to the 1/4 scale)
appended to the finest level. All take `train=True, generator=g` for the
training forward (batch statistics, drop-path and dropout drawn from g),
which returns the same outputs. The logits come out in the head's dtype
(resized as `jax.image.resize` at that dtype). `slide_inference` runs a
segmentor over the same crop grid as the JAX package: crops of `crop`
every `stride`, the last row and column clamped to the border, several
crops batched into one forward (at most `max_fwd_images` images), logits
summed where crops overlap and divided by the count map, in float32.
`tta_inference` averages the float32 softmax of a segmentor over
rescaled and flipped copies of the image.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fudanocr_tpu_torch.models.seg.cascade_mit import upsample
from fudanocr_tpu_torch.ops.resize import resize_bilinear


def nchw(img: torch.Tensor) -> torch.Tensor:
    """NHWC -> a contiguous NCHW copy. Not the channels-last view: on the
    CPU, torch 2.13's backward of a 1x1 stride-2 convolution (the ResNet
    shortcuts) over a channels-last input corrupts the heap."""
    return img.permute(0, 3, 1, 2).contiguous()


class EncoderDecoder(nn.Module):
    """Backbone + decode head, keys `backbone.*` and `decode_head.*`."""

    PORTER = "segmentor"

    def __init__(self, backbone: nn.Module, decode_head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head

    @property
    def jax_porter(self):
        """The whole segmentor's porter, with the backbone's shape."""
        return self.PORTER, dict(self.backbone.jax_porter[1])

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

    PORTER = "segmentor_det"

    def forward(self, img: torch.Tensor,
                det_gt: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = nchw(img)
        feats, det_logits = self.backbone(x, det_gt, train, generator)
        logits = upsample(self.decode_head(feats, train, generator), x)
        return logits.permute(0, 2, 3, 1), det_logits.permute(0, 2, 3, 1)


class CascadeEncoderDecoder(nn.Module):
    """Backbone + a cascade of decode heads (JAX encoder_decoder.py:44-66):
    head k > 0 sees the features with the previous logits, bilinearly
    resized to the finest level, concatenated to it. Keys `backbone.*` and
    `decode_head.{k}.*`, mmseg's ModuleList (so `SegAdam` gives the heads
    the head's lr x10; the JAX optimizer, whose rule reads the top-level
    names `decode_heads_{k}`, gives them x1)."""

    def __init__(self, backbone: nn.Module, decode_heads: Sequence[nn.Module]):
        super().__init__()
        self.backbone = backbone
        self.decode_head = nn.ModuleList(decode_heads)

    jax_porter = EncoderDecoder.jax_porter
    PORTER = "cascade_segmentor"

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) image -> (B, H, W, num_classes) logits."""
        x = nchw(img)
        feats = self.backbone(x, train, generator)
        logits = self.decode_head[0](feats, train, generator)
        for head in self.decode_head[1:]:
            prev = upsample(logits, feats[0])
            aug = [torch.cat([feats[0], prev], 1)]
            logits = head(aug + list(feats[1:]), train, generator)
        return upsample(logits, x).permute(0, 2, 3, 1)


def tta_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                  img: torch.Tensor, scales: Sequence[float] = (1.0,),
                  flip: bool = True) -> torch.Tensor:
    """MultiScaleFlipAug (JAX encoder_decoder.py:89-112): `apply_fn` over
    NHWC `img` (B, H, W, 3) resized to int(H * s) x int(W * s) for each
    scale s (bilinear, antialiased when shrinking, as `jax.image.resize`),
    and with `flip` its horizontal mirror too; each variant's logits
    (mirrored back) resized to H x W at their dtype, softmax in float32,
    and the mean of those probabilities: (B, H, W, C) float32."""
    b, h, w, _ = img.shape
    acc, n = None, 0
    for s in scales:
        base = img if s == 1.0 else resize_bilinear(
            img.permute(0, 3, 1, 2), (int(h * s), int(w * s))).permute(
            0, 2, 3, 1)
        variants = [base] + ([base.flip(2)] if flip else [])
        for vi, v in enumerate(variants):
            logits = apply_fn(v)
            if vi == 1:
                logits = logits.flip(2)
            logits = resize_bilinear(logits.permute(0, 3, 1, 2),
                                     (h, w)).permute(0, 2, 3, 1)
            p = torch.softmax(logits.float(), -1)
            acc = p if acc is None else acc + p
            n += 1
    return acc / n


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
