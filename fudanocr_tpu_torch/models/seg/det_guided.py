"""Det-guided CascadeMiT (the V10 variant behind every `*_det` config):
port of fudanocr_tpu/models/seg/det_guided.py (reference text-
focused-Transformers/mmseg/models/backbones/cascade_mit.py:4581-5131).

On top of the cascade backbone of models/seg/cascade_mit.py it adds

* a multi-scale detection head: per pyramid level a 1x1 conv + BN to 8d
  channels, bilinear to the 1/4 scale, concat, a 1x1 fusion conv + BN and a
  1x1 classifier to 2-class det logits;
* `soft_argmax` of the det logits, detached: the text map (0, 1, or 0.5
  at an exact tie), or the nearest-resized `det_gt` when one is given;
* `instance_labels`: 4-connected components of the text map, labelled on
  the tensor's device (the JAX package's `instance_labels_device` output;
  see that function for how it differs from the reference's OpenCV
  contour fill);
* per level, a text-masked and an instance-masked encoder layer, whose
  attention suppresses pairs with EQUAL region ids (`region_vectors` ->
  `EfficientAttention(region=...)`, kernel B6 at large shapes), each
  followed by BN, blended by a learned sigmoid gate (`_GateFuse`);
* the cascade, whose fusion convs take [pyramid, upsampled, gated] and
  carry a BN (conv2..conv5 are Sequential(conv, BN) in V10).

Module names are the reference V10 state_dict keys that
`utils/porters.port_cascade_mit_v10` reads. Ids travel as float32: a tie
gives the id 0.5, which is foreground and an id of its own, and instance
ids (at most H/4*W/4 + 1) are exact in float32. Float32. `train=True,
generator=g` is the training forward of the JAX module: batch statistics
in every BN (det head, gates, branch BNs, fusion convs), drop-path in the
cascade stages (not in the branches, whose rate is 0 in JAX), the masks
carrying no gradient and the labelling run under no_grad.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from fudanocr_tpu_torch.models.seg.cascade_mit import (CascadeStage,
                                                       ResNetBlock,
                                                       StemConv4x, Region,
                                                       TransformerEncoderLayer,
                                                       drop_path_rates,
                                                       run_blocks, to_map,
                                                       to_tokens, upsample)
from fudanocr_tpu_torch.nn.layers import batch_norm
from fudanocr_tpu_torch.ops.region_attention import region_mask


def soft_argmax(logits: torch.Tensor, beta: float = 1e10) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W): softmax(logits * beta) . [0, 1, ..]
    (det_guided.py:39-43), in float32."""
    p = torch.softmax(logits.float() * beta, -1)
    idx = torch.arange(logits.shape[-1], dtype=torch.float32,
                       device=logits.device)
    return (p * idx).sum(-1)


def instance_labels(text_map: torch.Tensor) -> torch.Tensor:
    """(B, H, W) text map -> (B, H, W) float32 instance ids: for each
    4-connected component of `text_map > 0`, the minimum linear index
    (h * W + w) of its pixels plus 1; 0 on background. The same output as
    the JAX package's `instance_labels_device` (det_guided.py:64-192).

    Runs on the tensor's device in plain torch. Every label is always the
    index of a pixel of the same component; a round takes the 4-neighbour
    minimum, hooks it onto the pixel's current root (`scatter_reduce`
    amin: the root learns the best adjacent label) and jumps pointers twice
    (`lab <- min(lab, lab[lab])`). The loop stops at the first round that
    changes nothing, which is the fixed point (every component constant at
    its minimum index). Past 4 * ceil(log2(H*W)) + 64 rounds it raises
    rather than return a partial labelling. The rounds of the last call
    are in `instance_labels.rounds`."""
    b, h, w = text_map.shape
    n = h * w
    dev = text_map.device
    fg = (text_map > 0).reshape(b, n)
    big = torch.tensor(n, dtype=torch.int64, device=dev)   # background
    lab = torch.where(fg, torch.arange(n, device=dev).expand(b, n), big)
    cap = 4 * math.ceil(math.log2(max(n, 2))) + 64
    rounds = 0
    while True:
        if rounds >= cap:
            raise RuntimeError(f"instance_labels: no fixed point after "
                               f"{rounds} rounds on a {tuple(text_map.shape)}"
                               f" map")
        new = _label_round(lab, fg, big, h, w)
        rounds += 1
        if torch.equal(new, lab):
            break
        lab = new
    instance_labels.rounds = rounds
    out = torch.where(fg, (lab + 1).float(), torch.zeros((), device=dev))
    return out.view(b, h, w)


instance_labels.rounds = 0


def _label_round(lab: torch.Tensor, fg: torch.Tensor, big: torch.Tensor,
                 h: int, w: int) -> torch.Tensor:
    b, n = lab.shape
    m = lab.view(b, h, w)
    cand = m.clone()
    torch.minimum(cand[:, 1:], m[:, :-1], out=cand[:, 1:])
    torch.minimum(cand[:, :-1], m[:, 1:], out=cand[:, :-1])
    torch.minimum(cand[:, :, 1:], m[:, :, :-1], out=cand[:, :, 1:])
    torch.minimum(cand[:, :, :-1], m[:, :, 1:], out=cand[:, :, :-1])
    cand = torch.where(fg, cand.view(b, n), big)
    # background points at index n - 1 with the sentinel: a no-op min
    hooked = lab.scatter_reduce(1, lab.clamp(max=n - 1), cand, reduce="amin")
    lab = torch.where(fg, torch.minimum(hooked, cand), big)
    for _ in range(2):
        lab = torch.where(fg, torch.minimum(
            lab, lab.gather(1, lab.clamp(max=n - 1))), big)
    return lab


def nearest_resize_torch(x: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) nearest resize with F.interpolate's "nearest" indexing
    (src = floor(dst * in / out)); an integer downscale is a strided slice
    (det_guided.py:236-249)."""
    _, h, w = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return x[:, ::h // oh, ::w // ow]
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x[:, iy][:, :, ix]


def region_vectors(region: torch.Tensor, hw: Tuple[int, int],
                   sr_ratio: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H0, W0) region ids -> ((B, Lq), (B, Lkv)) id vectors for the
    efficient attention at `hw` with K/V reduced by `sr_ratio`
    (det_guided.py:252-266)."""
    b = region.shape[0]
    h, w = hw
    rq = nearest_resize_torch(region, (h, w)).reshape(b, -1)
    hk, wk = max(h // sr_ratio, 1), max(w // sr_ratio, 1)
    rkv = nearest_resize_torch(region, (hk, wk)).reshape(b, -1)
    return rq, rkv


def region_attn_mask(region: torch.Tensor, hw: Tuple[int, int],
                     sr_ratio: int) -> torch.Tensor:
    """(B, H0, W0) region ids -> the (B, 1, Lq, Lkv) additive float mask of
    the reference's calculate_mask: -1e10 where the ids are equal, else 0
    (det_guided.py:269-282)."""
    return region_mask(*region_vectors(region, hw, sr_ratio))[:, None]


class _DetConvBN(nn.Sequential):
    """1x1 conv + BatchNorm, no activation (keys `0`, `1`)."""

    def __init__(self, in_features: int, features: int, bias: bool = True):
        super().__init__(nn.Conv2d(in_features, features, 1, bias=bias),
                         nn.BatchNorm2d(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return batch_norm(self[1], self[0](x), train)


class _GateFuse(_DetConvBN):
    """w = sigmoid(BN(conv1x1([text, inst]))); w * text + (1 - w) * inst
    (det_guided.py:298-309)."""

    def __init__(self, features: int):
        super().__init__(2 * features, features)

    def forward(self, text: torch.Tensor, inst: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        g = torch.sigmoid(super().forward(torch.cat([text, inst], 1), train))
        return g * text + (1 - g) * inst


class CascadeMiTDetGuided(nn.Module):
    """NCHW image (and optional (B, H, W) {0, 1} `det_gt`) -> (the 4-scale
    pyramid [(d, 1/4), (2d, 1/8), (5d, 1/16), (8d, 1/32)] NCHW, det logits
    (B, 2, H/4, W/4))."""

    def __init__(self, embed_dims: int = 32,
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratio: int = 4, in_features: int = 3,
                 kernels: bool = True, drop_path_rate: float = 0.1):
        super().__init__()
        d, nh = embed_dims, tuple(num_heads)
        dims = [d * n for n in nh]
        dpr = drop_path_rates(drop_path_rate, num_layers)
        self.sr_ratios = tuple(sr_ratios)
        self.conv1 = StemConv4x(in_features, d)
        self.bn1 = nn.BatchNorm2d(d)
        for i in range(3):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                ResNetBlock(dims[i], dims[i + 1], 2),
                ResNetBlock(dims[i + 1], dims[i + 1], 1)))
        self.layers = nn.ModuleList(
            CascadeStage(dims[i], dims[i], num_layers[i], nh[i],
                         sr_ratios[i], mlp_ratio, kernels, dpr[i])
            for i in range(4))
        # conv2..conv5 fuse levels 4..1: [pyramid, (upsampled,) gated]
        for i in range(4):
            lvl = 3 - i
            width = 2 * dims[lvl] + (dims[lvl + 1] if lvl < 3 else 0)
            self.add_module(f"conv{2 + i}",
                            _DetConvBN(width, dims[lvl], bias=False))
        for i in range(4):
            self.add_module(f"out_det_{i + 1}", _DetConvBN(dims[i], dims[3]))
            for kind in ("text", "instance"):
                self.add_module(f"{kind}_sa_{i + 1}", TransformerEncoderLayer(
                    dims[i], nh[i], mlp_ratio, sr_ratios[i], kernels))
                self.add_module(f"{kind}_sa_bn_{i + 1}",
                                nn.BatchNorm2d(dims[i]))
            self.add_module(f"fuse_text_instance_{i + 1}", _GateFuse(dims[i]))
        self.fusion_conv = _DetConvBN(4 * dims[3], dims[3])
        self.det_cls = nn.Sequential(nn.Conv2d(dims[3], 2, 1))

    def _branch(self, kind: str, i: int, f: torch.Tensor, region: Region,
                train: bool) -> torch.Tensor:
        hw = tuple(f.shape[-2:])
        y = getattr(self, f"{kind}_sa_{i + 1}")(to_tokens(f), hw, region)
        return batch_norm(getattr(self, f"{kind}_sa_bn_{i + 1}"),
                          to_map(y, hw), train)

    def forward(self, x: torch.Tensor,
                det_gt: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        x1 = batch_norm(self.bn1, self.conv1(x), train)
        feats = [x1]
        for i in range(3):
            feats.append(run_blocks(getattr(self, f"layer{i + 1}"),
                                    feats[-1], train))

        det = [upsample(getattr(self, f"out_det_{i + 1}")(f, train), x1)
               for i, f in enumerate(feats)]
        det_logits = self.det_cls(self.fusion_conv(torch.cat(det, 1), train))

        hw1 = tuple(x1.shape[-2:])
        # the masks carry no gradient (the reference's pass through numpy
        # and .long())
        with torch.no_grad():
            if det_gt is not None:
                text_map = nearest_resize_torch(det_gt.float(), hw1)
            else:
                text_map = soft_argmax(det_logits.permute(0, 2, 3, 1))
            inst_map = instance_labels(text_map)

        fused = []
        for i, f in enumerate(feats):
            hw, sr = tuple(f.shape[-2:]), self.sr_ratios[i]
            text = self._branch("text", i, f,
                                region_vectors(text_map, hw, sr), train)
            inst = self._branch("instance", i, f,
                                region_vectors(inst_map, hw, sr), train)
            fused.append(getattr(self, f"fuse_text_instance_{i + 1}")(
                text, inst, train))

        x1, x2, x3, x4 = feats
        stage = lambda i, t: self.layers[i](t, train, generator)
        cat = lambda i, parts: getattr(self, f"conv{i}")(torch.cat(parts, 1),
                                                         train)
        x4_ = stage(3, cat(2, [x4, fused[3]]))
        x3_ = stage(2, cat(3, [x3, upsample(x4_, x3), fused[2]]))
        x2_ = stage(1, cat(4, [x2, upsample(x3_, x2), fused[1]]))
        x1_ = stage(0, cat(5, [x1, upsample(x2_, x1), fused[0]]))
        return [x1_, x2_, x3_, x4_], det_logits
