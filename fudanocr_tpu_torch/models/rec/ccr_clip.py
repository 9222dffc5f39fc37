"""CCR-CLIP (ICCV-23): a dual encoder aligning character images with
their radical (IDS) sequences (port of fudanocr_tpu/models/rec/ccr_clip.py;
reference image-ids-CTR/CCR-CLIP/model.py:135-221 + resnet50.py:13-111).

* image tower: a ResNet-50 bottleneck stack with a 3x3 stride-1 stem (not
  torchvision's 7x7/2), a 3x3/2 max pool (padding 1), a global mean pool
  -> 2048-d features;
* text tower: a 12-layer pre-LN transformer (width 512, 8 heads, QuickGELU
  MLP x4, `nn.LayerNorm` eps 1e-5) over radical tokens with a causal
  mask (scores where(causal, s, -1e30) in fp32), learned positional
  embeddings, a final LayerNorm, EOT pooling at the '$' token (the
  largest id, argmax of the ids, model.py:205) and a 512 -> 2048
  projection;
* a learnable logit_scale initialised to ln(1/0.07).

`dtype=torch.bfloat16` is JAX's `dtype=`: parameters stay float32, every
conv, product and LayerNorm rounds its result to bf16 (the LayerNorms
with float32 statistics), and the text tower's residual stream stays
float32 as JAX's promotion keeps it (the float32 embeddings plus bf16
block outputs). `dtype=None` computes in the parameters' dtype. Feature
normalisation runs in fp32. BatchNorm follows flax (momentum 0.9,
the biased batch variance into the running statistics, ROADMAP C7) through
`nn/layers.batch_norm`. Module names are the reference state_dict's
(`visual.layer{s}.{i}.conv1`, `transformer.resblocks.{i}.attn.
in_proj_weight`, ...), which `utils/porters.port_ccr_clip` reads. Images
are NHWC at the public functions, NCHW inside. Plain PyTorch throughout:
the JAX towers reach no Pallas kernel.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.nn.layers import batch_norm, conv2d, linear


def _ln(m: nn.LayerNorm, x: torch.Tensor,
        dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `LayerNorm(dtype=)`: float32 statistics and affine, the
    result in `dtype`; `m(x)` when `dtype` is None."""
    if dtype is None:
        return m(x)
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias,
                        m.eps).to(dtype)


class Bottleneck(nn.Module):
    """1x1 - 3x3 (stride, padding 1) - 1x1 x4 with BN, residual through a
    strided 1x1 conv + BN where the shape changes; no conv biases."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
            nn.BatchNorm2d(out_ch)) if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        y = F.relu(batch_norm(self.bn2, conv2d(self.conv2, y), train))
        y = batch_norm(self.bn3, conv2d(self.conv3, y), train)
        if self.downsample is not None:
            x = batch_norm(self.downsample[1],
                           conv2d(self.downsample[0], x), train)
        return F.relu(y + x)


class CLIPResNet50(nn.Module):
    """resnet50.py:51-111: 3x3/1 stem, 4 bottleneck stages, mean pool ->
    (B, 2048). NHWC in; the image is rounded to `dtype` when given."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = tuple(layers)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for s, (n, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            blocks = []
            for i in range(n):
                stride = 2 if (i == 0 and s > 0) else 1
                down = i == 0 and (stride != 1 or in_ch != planes * 4)
                blocks.append(Bottleneck(in_ch, planes, stride, down))
                in_ch = planes * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype or x.dtype).contiguous()
        x = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(len(self.layers)):
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, train)
        return x.mean((2, 3))


class QuickGELU(nn.Module):
    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h * torch.sigmoid(1.702 * h)   # model.py:59-62


class _Attention(nn.Module):
    """The parameters of torch's nn.MultiheadAttention (`in_proj_weight`,
    `in_proj_bias`, `out_proj`) under their reference names."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(width, width)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x)); scores in
    fp32, masked to -1e30 above the diagonal when `causal`; each
    LayerNorm returns `dtype` (see `_ln`)."""

    def __init__(self, width: int, heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)), ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width))]))

    def forward(self, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads
        h = _ln(self.ln_1, x, self.dtype)
        qkv = F.linear(h, self.attn.in_proj_weight.to(h.dtype),
                       self.attn.in_proj_bias.to(h.dtype))
        q, k, v = (t.reshape(b, l, self.heads, hd).transpose(1, 2)
                   for t in qkv.split(d, -1))
        s = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
        if causal:
            keep = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
            s = s.masked_fill(~keep, -1e30)
        o = (s.softmax(-1).to(v.dtype) @ v).transpose(1, 2).reshape(b, l, d)
        x = x + linear(self.attn.out_proj, o)
        h = linear(self.mlp.c_fc, _ln(self.ln_2, x, self.dtype))
        return x + linear(self.mlp.c_proj, self.mlp.gelu(h))


class _Transformer(nn.Module):
    """The reference's `transformer.resblocks` nesting."""

    def __init__(self, width: int, layers: int, heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, dtype)
             for _ in range(layers)])

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, causal)
        return x


class VisionTransformer(nn.Module):
    """CLIP ViT image tower (CCR-CLIP/model.py:99-132). The reference
    defines it and selects the ResNet (model.py:148-149); kept for config
    parity. `input_resolution` (H, W) sizes the positional embedding,
    which the JAX module infers from its first input. NHWC in."""

    def __init__(self, input_resolution: Tuple[int, int] = (128, 128),
                 patch_size: int = 16, width: int = 512, layers: int = 6,
                 heads: int = 8, output_dim: int = 2048,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        scale = width ** -0.5
        tokens = (input_resolution[0] // patch_size) * (
            input_resolution[1] // patch_size) + 1
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(tokens, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, layers, heads, dtype)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(scale * torch.randn(width, output_dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d(self.conv1, x.permute(0, 3, 1, 2).to(
            self.dtype or x.dtype).contiguous())
        b, w = x.shape[0], x.shape[1]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.to(x.dtype).expand(b, 1, w), x],
                      1)
        x = _ln(self.ln_pre, x + self.positional_embedding.to(x.dtype),
                self.dtype)
        x = self.transformer(x, causal=False)
        x = _ln(self.ln_post, x[:, 0], self.dtype)
        return x @ self.proj.to(x.dtype)


class CCRCLIP(nn.Module):
    """Image and radical-sequence towers with a learnable temperature."""

    def __init__(self, vocab_size: int, embed_dim: int = 2048,
                 context_length: int = 30, transformer_width: int = 512,
                 transformer_heads: int = 8, transformer_layers: int = 12,
                 vision_layers: Sequence[int] = (3, 4, 6, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.visual = CLIPResNet50(vision_layers, dtype)
        self.token_embedding = nn.Embedding(vocab_size, transformer_width)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context_length, transformer_width))
        self.transformer = _Transformer(transformer_width, transformer_layers,
                                        transformer_heads, dtype)
        self.ln_final = nn.LayerNorm(transformer_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            transformer_width ** -0.5
            * torch.randn(transformer_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, image: torch.Tensor,
                     train: bool = False) -> torch.Tensor:
        return self.visual(image, train)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """(B, L) radical ids -> (B, embed_dim), pooled at each row's
        largest id (the terminator '$')."""
        l = text.shape[1]
        x = self.token_embedding(text) + self.positional_embedding[:l]
        x = _ln(self.ln_final, self.transformer(x, causal=True), self.dtype)
        eot = text.argmax(-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (image features, text features), each unit-norm fp32, and
        exp(logit_scale)."""
        img = self.encode_image(image, train).float()
        txt = self.encode_text(text).float()
        img = img / img.norm(dim=1, keepdim=True)
        txt = txt / txt.norm(dim=1, keepdim=True)
        return img, txt, self.logit_scale.exp()
