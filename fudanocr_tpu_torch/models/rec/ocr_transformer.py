"""Shared CTR core: ResNet encoder + 1-layer transformer decoder (port of
fudanocr_tpu/models/rec/ocr_transformer.py). It is the frozen text-focus
oracle of TBSRN training (scene-text-telescope/loss/transformer.py:348-389,
`OCRTransformer(vocab=37, num_in=1, layers=(1, 2, 5, 3), num_heads=16)`),
the SLD recogniser (`stage1_pool=False`) and CCR-CLIP's stage-2 model
(`encoder_preset="image_ids"`, `out_dim=2048`: embeddings matched against
a gallery).

Module names follow the reference state_dict that
`utils/porters.port_ocr_transformer` reads, with the
oracle's `encoder.cnn.` prefix: `encoder.cnn.{conv1,bn1,conv2,bn2}`,
`encoder.cnn.layer{s}.{i}.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}`,
`encoder.cnn.layer{s}_conv/_bn`, `encoder.cnn.layer4_conv2/_bn`,
`embedding_word.lut`, `decoder.{mask_multihead,multihead}.linears.*`,
`decoder.mul_layernorm{1,2,3}`, `decoder.pff.w_{1,2}`, `generator_word.proj`.
So `load_jax_variables(m, "ocr_transformer", variables, layers=...)` moves
JAX weights in.

Images are NHWC at the public functions, as in the JAX package; the
encoder runs NCHW inside. Teacher-forced decoding over fixed-length
padded text with a causal mask, as the JAX module does. `greedy_decode`
and `greedy_decode_gallery` are JAX's static-shape decoders: encode once,
then `max_len` decoder passes over the whole padded token buffer, each
writing one slot. They recompute the whole prefix each step, as JAX does
(a KV cache would change the products' shapes and so near-tie argmaxes),
and keep the ids on the device until the caller copies them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.nn.attention import (MultiHeadAttention,
                                             positional_encoding_1d)
from fudanocr_tpu_torch.nn.layers import (PositionwiseFeedForward,
                                          TorchLayerNorm, batch_norm, conv2d,
                                          dropout, linear, max_pool)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class BasicBlock(nn.Module):
    """conv3-bn-relu-conv3-bn + (optionally downsampled) residual, relu."""

    def __init__(self, in_features: int, features: int,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv3(in_features, features)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = _conv3(features, features)
        self.bn2 = nn.BatchNorm2d(features)
        self.downsample = (nn.Sequential(_conv3(in_features, features),
                                         nn.BatchNorm2d(features))
                           if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        y = batch_norm(self.bn2, conv2d(self.conv2, y), train)
        if self.downsample is not None:
            x = batch_norm(self.downsample[1],
                           conv2d(self.downsample[0], x), train)
        return F.relu(y + x)


class OCRResNet(nn.Module):
    """The CTR encoder family (see the JAX module): `stage_pools[s]`
    pools before stage s, `stage_convs[s]` adds conv+BN+ReLU after it,
    `head_conv` adds the final 1024-wide conv. `width_div` divides every
    channel width (at least 4; small test models only). NCHW in and
    out."""

    def __init__(self, num_in: int = 3, layers: Sequence[int] = (3, 4, 6, 3),
                 stage_feats: Sequence[int] = (256, 256, 512, 512),
                 stage_pools: Sequence[bool] = (True, False, False, False),
                 stage_convs: Sequence[bool] = (True, True, True, False),
                 head_conv: bool = True, width_div: int = 1):
        super().__init__()
        self.layers = tuple(layers)
        self.stage_pools = tuple(stage_pools)
        self.stage_convs = tuple(stage_convs)
        self.head_conv = head_conv
        w = lambda f: max(f // width_div, 4)
        self.conv1, self.bn1 = _conv3(num_in, w(64)), nn.BatchNorm2d(w(64))
        self.conv2, self.bn2 = _conv3(w(64), w(128)), nn.BatchNorm2d(w(128))
        in_feats = w(128)
        for s, (n_blocks, feats) in enumerate(zip(layers, stage_feats)):
            feats = w(feats)
            setattr(self, f"layer{s + 1}", nn.Sequential(*[
                BasicBlock(in_feats if i == 0 else feats, feats,
                           downsample=(i == 0 and in_feats != feats))
                for i in range(n_blocks)]))
            if stage_convs[s]:
                setattr(self, f"layer{s + 1}_conv", _conv3(feats, feats))
                setattr(self, f"layer{s + 1}_bn", nn.BatchNorm2d(feats))
            in_feats = feats
        if head_conv:
            self.layer4_conv2 = _conv3(in_feats, w(1024))
            self.layer4_conv2_bn = nn.BatchNorm2d(w(1024))
            in_feats = w(1024)
        self.out_features = in_feats

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        def conv_bn_relu(conv, bn, x):
            return F.relu(batch_norm(bn, conv2d(conv, x), train))

        x = max_pool(conv_bn_relu(self.conv1, self.bn1, x), 2)
        x = conv_bn_relu(self.conv2, self.bn2, x)
        for s in range(len(self.layers)):
            if self.stage_pools[s]:
                x = max_pool(x, 2)
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, train)
            if self.stage_convs[s]:
                x = conv_bn_relu(getattr(self, f"layer{s + 1}_conv"),
                                 getattr(self, f"layer{s + 1}_bn"), x)
        if self.head_conv:
            x = conv_bn_relu(self.layer4_conv2, self.layer4_conv2_bn, x)
        return x


# encoder presets per reference project (the JAX module's table)
OCR_RESNET_PRESETS = {
    "oracle": dict(layers=(1, 2, 5, 3)),
    "sld": dict(layers=(3, 4, 6, 3),
                stage_pools=(False, False, False, False)),
    "oictr": dict(layers=(3, 4, 6), stage_feats=(256, 512, 1024),
                  stage_pools=(True, True, False),
                  stage_convs=(True, True, True), head_conv=False),
    "image_ids": dict(layers=(3, 4, 6), stage_feats=(256, 512, 1024),
                      stage_pools=(True, True, True),
                      stage_convs=(True, True, True), head_conv=False),
}


class OCRDecoderLayer(nn.Module):
    """Masked self-attention, cross-attention to the conv tokens (returns
    the map), FFN; each with residual + the reference's std LayerNorm
    (through the fused residual-LayerNorm op)."""

    dropout_rate = 0.1   # after the FFN's ReLU in train mode

    def __init__(self, num_heads: int = 4, d_model: int = 1024,
                 d_ff: int = 2048, memory_features: Optional[int] = None,
                 kernels: bool = True):
        super().__init__()
        self.mask_multihead = MultiHeadAttention(num_heads, d_model,
                                                 kernels=kernels)
        self.mul_layernorm1 = TorchLayerNorm(d_model, kernels=kernels)
        self.multihead = MultiHeadAttention(num_heads, d_model,
                                            kv_features=memory_features,
                                            kernels=kernels)
        self.mul_layernorm2 = TorchLayerNorm(d_model, kernels=kernels)
        self.pff = PositionwiseFeedForward(d_model, d_ff)
        self.mul_layernorm3 = TorchLayerNorm(d_model, kernels=kernels)

    def forward(self, text: torch.Tensor, memory: torch.Tensor,
                self_mask: torch.Tensor, deterministic: bool = True,
                attention_map: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sa, _ = self.mask_multihead(text, text, text, mask=self_mask,
                                    deterministic=deterministic,
                                    need_weights=False, generator=generator)
        x = self.mul_layernorm1(text, sa)
        ca, attn_map = self.multihead(x, memory, memory,
                                      attention_map=attention_map,
                                      deterministic=deterministic,
                                      generator=generator)
        x = self.mul_layernorm2(x, ca)
        y = F.relu(linear(self.pff.w_1, x))
        if not deterministic:
            y = dropout(y, self.dropout_rate, generator)
        x = self.mul_layernorm3(x, linear(self.pff.w_2, y))
        return x, attn_map


class _Encoder(nn.Module):
    """The reference's `encoder.cnn` nesting."""

    def __init__(self, cnn: OCRResNet):
        super().__init__()
        self.cnn = cnn


class _Embeddings(nn.Module):
    """The reference's `embedding_word.lut`."""

    def __init__(self, vocab: int, d_embed: int):
        super().__init__()
        self.lut = nn.Embedding(vocab, d_embed)


class _Generator(nn.Module):
    """The reference's `generator_word.proj`."""

    def __init__(self, d_model: int, out: int):
        super().__init__()
        self.proj = nn.Linear(d_model, out)


class TokenDecoding(nn.Module):
    """The teacher-forced decoding half of the CTR models (OCRTransformer,
    OICTR, ACPM): the token embedding at half the decoder width beside a
    1-D positional code, one `OCRDecoderLayer` under a causal mask, and
    the generator. A subclass sets `d_embed`, `dtype` (None: the
    parameters' dtype), `embedding_word`, `decoder` and
    `generator_word`."""

    def __init__(self):
        super().__init__()
        self._consts: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.embedding_word.lut.weight.dtype

    def _pe_and_mask(self, l: int, device, dtype) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
        key = (l, device, dtype)
        if key not in self._consts:   # one host-to-device copy per length
            pe = torch.from_numpy(positional_encoding_1d(self.d_embed, l))
            self._consts[key] = (
                pe.to(device, dtype),
                torch.ones(l, l, dtype=torch.bool, device=device).tril())
        return self._consts[key]

    def decode_step(self, memory: torch.Tensor, text_input: torch.Tensor,
                    train: bool = False,
                    attention_map: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, L) token ids + memory -> (logits, attention map, hidden)."""
        b, l = text_input.shape
        dtype = self.compute_dtype()
        emb = (self.embedding_word.lut(text_input).to(dtype)
               * math.sqrt(self.d_embed))
        pe, mask = self._pe_and_mask(l, text_input.device, dtype)
        # the reference CONCATs a pure positional vector to the embedding
        # (loss/transformer.py:369-370) instead of adding it
        x = torch.cat([emb, pe.expand(b, l, self.d_embed)], dim=-1)
        x, attn_map = self.decoder(x, memory, mask[None, None],
                                   deterministic=not train,
                                   attention_map=attention_map,
                                   generator=generator)
        return linear(self.generator_word.proj, x), attn_map, x


class OCRTransformer(TokenDecoding):
    """ResNet encoder + one transformer decoder layer + generator of
    `vocab` logits, or of `out_dim`-wide embeddings.

    `encoder_preset` (a key of OCR_RESNET_PRESETS) replaces `layers`;
    `stage1_pool=False` pools at the stem only (SLD, ACPM);
    `encoder_width_div` divides the encoder's widths (small test models).
    `kernels=False` runs the plain PyTorch versions of the kernels its
    LayerNorms reach (the comparison path). Parameters stay float32;
    `dtype` is the compute dtype (JAX's `dtype=`: the image and every
    activation are rounded to it, the decoder's LayerNorms return it)."""

    def __init__(self, vocab: int, num_in: int = 3,
                 layers: Sequence[int] = (3, 4, 6, 3), num_heads: int = 4,
                 d_embed: int = 512, d_model: int = 1024, d_ff: int = 2048,
                 out_dim: Optional[int] = None, stage1_pool: bool = True,
                 encoder_preset: Optional[str] = None,
                 encoder_width_div: int = 1, kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder_preset is not None:
            kw = dict(OCR_RESNET_PRESETS[encoder_preset])
        else:
            kw = dict(layers=tuple(layers))
            if not stage1_pool:
                kw["stage_pools"] = (False,) * 4
        if 2 * d_embed != d_model:
            raise ValueError(f"the decoder input concatenates the embedding "
                             f"and its positional code: d_model {d_model} "
                             f"must be 2 * d_embed {d_embed}")
        self.d_embed, self.dtype = d_embed, dtype
        self.encoder = _Encoder(OCRResNet(num_in, width_div=encoder_width_div,
                                          **kw))
        mem = self.encoder.cnn.out_features
        self.embedding_word = _Embeddings(vocab, d_embed)
        self.decoder = OCRDecoderLayer(
            num_heads, d_model, d_ff,
            memory_features=None if mem == d_model else mem, kernels=kernels)
        self.generator_word = _Generator(d_model, out_dim or vocab)

    def encode(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NHWC image -> (B, Ht*Wt, C) memory tokens."""
        conv = self.encoder.cnn(image.permute(0, 3, 1, 2).to(self.dtype),
                                train)
        return conv.flatten(2).transpose(1, 2)

    def forward(self, image: torch.Tensor, text_input: torch.Tensor,
                train: bool = False,
                attention_map: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: dense (B, L, out) predictions, the
        cross-attention map (B, H, L, Ht*Wt), the memory and the decoder
        output."""
        memory = self.encode(image, train)
        pred, attn_map, hidden = self.decode_step(
            memory, text_input, train, attention_map, generator)
        return {"pred": pred, "map": attn_map, "conv": memory,
                "hidden": hidden}


def _token_buffer(memory: torch.Tensor, max_len: int,
                  start_id: int) -> torch.Tensor:
    return torch.full((memory.shape[0], max_len + 1), start_id,
                      dtype=torch.long, device=memory.device)


@torch.no_grad()
def greedy_decode(model: nn.Module, image: torch.Tensor, max_len: int,
                  start_id: int = 0) -> torch.Tensor:
    """Greedy autoregressive decode (JAX `greedy_decode`): encode once,
    then `max_len` inference passes of `model.decode_step` over the whole
    (B, max_len + 1) token buffer (start id `start_id`); pass i writes the
    argmax of its output at position i into slot i + 1. Returns the
    (B, max_len) int64 ids on the image's device: the caller copies them
    once. `model` is any module with `encode` and `decode_step`
    (OCRTransformer, OICTR, ACPM)."""
    memory = model.encode(image)
    tokens = _token_buffer(memory, max_len, start_id)
    for i in range(max_len):
        out, _, _ = model.decode_step(memory, tokens)
        tokens[:, i + 1] = out[:, i].argmax(-1)
    return tokens[:, 1:]


@torch.no_grad()
def greedy_decode_gallery(model: nn.Module, image: torch.Tensor,
                          gallery: torch.Tensor, max_len: int,
                          start_id: int = 0) -> torch.Tensor:
    """`greedy_decode` for embedding generators (JAX
    `greedy_decode_gallery`, CCR-CLIP stage 2): each step's fp32 output
    embedding, divided by max(its norm, 1e-8), is matched against the
    frozen `gallery` (V, D) by cosine; the argmax is the next id."""
    memory = model.encode(image)
    g = gallery.float()
    tokens = _token_buffer(memory, max_len, start_id)
    for i in range(max_len):
        out, _, _ = model.decode_step(memory, tokens)
        emb = out[:, i].float()
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        tokens[:, i + 1] = (emb @ g.T).argmax(-1)
    return tokens[:, 1:]
