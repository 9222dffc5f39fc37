"""Orientation-independent CTR (IJCAI-23) (port of
fudanocr_tpu/models/rec/oictr.py; reference orientation-independent-CTR/
model/transformer.py:370-496 + model/reconstruct.py:104-133).

The wide 3-stage ResNet encoder (`OCR_RESNET_PRESETS["oictr"]`) feeds

* a content branch: a 1024 -> d_model 1x1 conv whose tokens the decoder
  (4 heads, FFN x2) cross-attends; a linear generator over the alphabet;
* a direction branch: a 1024 -> d_model 1x1 conv, a global mean pool, a
  linear layer, and a 2-way horizontal/vertical classifier on top;
* per-character feature maps: the head-mean cross-attention map times
  the content tokens, compressed along the token axis to 4 cells
  (`features_compress`, the reference's conv over that axis) ->
  (d_model, 2, 2) per character;
* a deconvolution reconstructor that renders each character as a 32x32
  RGB image from [char map ; its direction feature] (2 * d_model, 2, 2),
  for the reconstruction and direction-swap losses.

As in JAX, the char maps stay a dense (B, L, ...) grid (the losses mask
the invalid positions) where the reference packs them raggedly
(transformer.py:455-462), and the direction-swap permutation is a host
gather index. The token count of `features_compress` follows from
`image_size`, which the JAX module infers at init. The reconstructor is
JAX's redesign (four stride-2 5x5 transposed convs, SAME, no kernel
flip, then a 5x5 conv): each runs as torch's transposed conv with
padding 1, cropped to 2x its input; its names
(`reconstructor.deconv{1..5}`) are the port's, as the reference's
module differs. The other names are the reference state_dict's
(`encoder.layer{s}.{i}.conv1`, `content_extractor`, ...), which
`utils/porters.port_oictr` reads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.models.rec.ocr_transformer import (
    OCR_RESNET_PRESETS, OCRDecoderLayer, OCRResNet, TokenDecoding,
    _Embeddings, _Generator)
from fudanocr_tpu_torch.nn.layers import conv2d, conv_transpose2d, linear


class CharReconstructor(nn.Module):
    """(N, 2 * base, 2, 2) NCHW -> (N, 32, 32, 3) NHWC in [-1, 1]: four
    stride-2 deconvs (ReLU, ReLU, ReLU, tanh), a 5x5 conv, tanh."""

    def __init__(self, base: int = 512):
        super().__init__()
        feats = (base, base // 2, base // 4, base // 8)
        cin = 2 * base
        for i, f in enumerate(feats):
            setattr(self, f"deconv{i + 1}",
                    nn.ConvTranspose2d(cin, f, 5, stride=2, padding=1))
            cin = f
        self.deconv5 = nn.Conv2d(cin, 3, 5, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            h, w = x.shape[2:]
            x = conv_transpose2d(getattr(self, f"deconv{i + 1}"), x)[
                :, :, :2 * h, :2 * w]
            x = F.relu(x) if i < 3 else torch.tanh(x)
        x = torch.tanh(conv2d(self.deconv5, x))
        return x.permute(0, 2, 3, 1)


class _DirectionExtractor(nn.Module):
    """The reference's `direction_extractor.{conv1, linear}`."""

    def __init__(self, cin: int, d_model: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, d_model, 1)
        self.linear = nn.Linear(d_model, d_model)


def memory_tokens(image_size: Tuple[int, int], stage_pools) -> int:
    """Ht * Wt of the encoder's output: the stem pool and each stage pool
    halve (floor) both sides."""
    h, w = image_size
    for _ in range(1 + sum(bool(p) for p in stage_pools)):
        h, w = h // 2, w // 2
    return h * w


class OICTR(TokenDecoding):
    """Recognition, direction and reconstruction branches over one wide
    encoder. `encoder_layers` overrides the blocks per stage (reference
    (3, 4, 6)), `encoder_width_div` divides the encoder's widths (small
    test models only). `kernels=False` runs the decoder LayerNorms' plain
    version (the comparison path). `dtype` is the compute dtype
    (parameters stay float32; None: the parameters' dtype): the char maps
    are formed in float32 and rounded to it before their compression, as
    in JAX."""

    def __init__(self, vocab: int, d_embed: int = 256, d_model: int = 512,
                 num_heads: int = 4, image_size: Tuple[int, int] = (32, 128),
                 encoder_layers: Optional[Tuple[int, ...]] = None,
                 encoder_width_div: int = 1, kernels: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if 2 * d_embed != d_model:
            raise ValueError(f"d_model {d_model} must be 2 * d_embed "
                             f"{d_embed}")
        kw = dict(OCR_RESNET_PRESETS["oictr"])
        if encoder_layers is not None:
            kw["layers"] = tuple(encoder_layers)
        self.d_embed, self.d_model, self.dtype = d_embed, d_model, dtype
        self.encoder = OCRResNet(3, width_div=encoder_width_div, **kw)
        raw = self.encoder.out_features
        self.content_extractor = nn.Conv2d(raw, d_model, 1)
        self.direction_extractor = _DirectionExtractor(raw, d_model)
        self.direction_cls = nn.Linear(d_model, 2)
        self.embedding_word = _Embeddings(vocab, d_embed)
        self.decoder = OCRDecoderLayer(num_heads, d_model, 2 * d_model,
                                       kernels=kernels)
        self.generator_word = _Generator(d_model, vocab)
        self.features_compress = nn.Conv2d(
            memory_tokens(image_size, kw["stage_pools"]), 4, 1)
        self.reconstructor = CharReconstructor(d_model)

    def _raw(self, image: torch.Tensor, train: bool) -> torch.Tensor:
        return self.encoder(image.permute(0, 3, 1, 2).to(
            self.compute_dtype()).contiguous(), train)

    def _memory(self, raw: torch.Tensor) -> torch.Tensor:
        return conv2d(self.content_extractor, raw).flatten(2).transpose(1, 2)

    def _direction(self, raw: torch.Tensor):
        d = conv2d(self.direction_extractor.conv1, raw).mean((2, 3))
        d = linear(self.direction_extractor.linear, d)
        return d, linear(self.direction_cls, d)

    def encode(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NHWC image -> (B, Ht*Wt, d_model) content tokens."""
        return self._memory(self._raw(image, train))

    def direction_features(self, image: torch.Tensor, train: bool = False):
        """-> (direction feature (B, d_model), direction logits (B, 2))."""
        return self._direction(self._raw(image, train))

    def reconstruct(self, char_maps: torch.Tensor,
                    dir_feats: torch.Tensor) -> torch.Tensor:
        """char_maps (N, d_model, 4), dir_feats (N, d_model) ->
        (N, 32, 32, 3)."""
        n, d = char_maps.shape[0], self.d_model
        cm = char_maps.reshape(n, d, 2, 2)
        df = dir_feats[:, :, None, None].expand(n, d, 2, 2)
        return self.reconstructor(torch.cat([cm, df], 1))

    def forward(self, image: torch.Tensor, text_input: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        raw = self._raw(image, train)
        memory = self._memory(raw)
        pred, attn_map, hidden = self.decode_step(memory, text_input, train,
                                                  generator=generator)
        direction_feat, direction_logits = self._direction(raw)
        # per-char maps: head-mean attention x content tokens
        # (transformer.py:444-448), compressed over the tokens to 4 cells
        amap = attn_map.float().mean(1)                       # (B, L, T)
        cm = (memory.float()[:, None] * amap[..., None]).to(
            self.compute_dtype())
        w = self.features_compress                          # (B, L, T, C)
        char_maps = F.linear(cm.transpose(2, 3),
                             w.weight[:, :, 0, 0].to(cm.dtype),
                             w.bias.to(cm.dtype))             # (B, L, C, 4)
        b, l = text_input.shape
        raw_imgs = self.reconstruct(
            char_maps.reshape(b * l, self.d_model, 4),
            direction_feat.repeat_interleave(l, 0))
        return {"pred": pred, "map": attn_map, "conv": memory,
                "hidden": hidden, "char_maps": char_maps,
                "direction_feat": direction_feat,
                "direction_logits": direction_logits, "raw_imgs": raw_imgs}
