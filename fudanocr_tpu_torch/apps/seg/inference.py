"""Segmentation inference API (port of fudanocr_tpu/apps/seg/inference.py
and `build_model` of apps/seg/train.py:65-87; mmseg/apis/inference.py).

    model, cfg = init_segmentor("configs/seg/textformer_b0_textseg.yaml")
    seg = inference_segmentor(model, image, crop=(1024, 1024),
                              stride=(768, 768))     # (H, W) class map
    overlay = show_result(image, seg)

`init_segmentor` builds the configured segmentor through the registries
(`core/registry.py`, as the JAX app's `build_model`): by default
`EncoderDecoder(CascadeMiT, SegformerHead)`, or for a det-guided config
(`model.det_guided: true`, every `*_det` file)
`DetGuidedEncoderDecoder(CascadeMiTDetGuided, SegformerHead)`, and any
registered `model.type` / `backbone.type` / `decode_head.type`; on the
card (unless `device` says otherwise), with the weights of a `checkpoint`
directory (the port's payload, `core/checkpoint.load_model_state`), or
JAX-layout numpy `variables` moved in through
`utils.weights.load_jax_variables` (porter `segmentor` or
`segmentor_det`), or else the modules' own initialisation drawn from
`seed`.
`inference_segmentor` normalises the image and runs the whole image
(`crop=None`) or the sliding window (the configs' test recipe is
`test.mode: slide`, crop 1024², stride 768²); of a det-guided model it keeps
the segmentation logits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.core.config import load_config, merge_cli_overrides
from fudanocr_tpu_torch.core.registry import BACKBONES, HEADS, SEGMENTORS
from fudanocr_tpu_torch.data.seg_pipeline import Normalize
from fudanocr_tpu_torch.models.seg import (CascadeEncoderDecoder,
                                           EncoderDecoder, slide_inference)
from fudanocr_tpu_torch.utils.weights import load_jax_variables, porter_of

DEFAULT_PALETTE = ((0, 0, 0), (220, 40, 40), (40, 220, 40), (40, 40, 220))


def backbone_kwargs(cfg) -> dict:
    """The backbone's shape from a config (the porter's arguments too)."""
    b = cfg.model.backbone
    return dict(embed_dims=b.embed_dims, num_layers=tuple(b.num_layers),
                num_heads=tuple(b.num_heads), sr_ratios=tuple(b.sr_ratios))


def is_det_guided(cfg) -> bool:
    return bool(cfg.model.get("det_guided", False))


def build_model(cfg, kernels: bool = True) -> EncoderDecoder:
    """The configured segmentor in eval mode on the CPU (its forward takes
    `train=True` for training), built through the registries with the JAX
    app's defaults (apps/seg/train.py:65-87): `model.type` (default
    EncoderDecoder, DetGuidedEncoderDecoder with `model.det_guided`), its
    `backbone.type` (CascadeMiT, CascadeMiTDetGuided) with the config's
    shape and drop-path rate, and `decode_head.type` (SegformerHead) with
    its classes, channels and dropout. A `CascadeEncoderDecoder` config
    raises: the JAX app cannot build one either (ROADMAP C21); the module
    itself is built directly."""
    m = cfg.model
    det = is_det_guided(cfg)
    segmentor = SEGMENTORS.get(m.get("type", "DetGuidedEncoderDecoder"
                                     if det else "EncoderDecoder"))
    if segmentor is CascadeEncoderDecoder:
        raise NotImplementedError(
            "model.type CascadeEncoderDecoder: no config builds a cascade of "
            "heads, and the JAX app's build_model cannot (ROADMAP C21); "
            "construct CascadeEncoderDecoder(backbone, heads) directly")
    b, h = m.backbone, m.decode_head
    kw = backbone_kwargs(cfg)
    backbone = BACKBONES.get(b.get("type", "CascadeMiTDetGuided" if det
                                   else "CascadeMiT"))(
        **kw, kernels=kernels, drop_path_rate=b.get("drop_path_rate", 0.1))
    d, nh = kw["embed_dims"], kw["num_heads"]
    head = HEADS.get(h.get("type", "SegformerHead"))(
        [d * n for n in (1,) + tuple(nh[1:])], num_classes=h.num_classes,
        channels=h.channels, dropout_ratio=h.get("dropout_ratio", 0.1))
    return segmentor(backbone, head).eval()


def init_segmentor(config_path: str, variables=None, device="cuda",
                   overrides: Sequence[str] = (), seed: int = 0,
                   kernels: bool = True, checkpoint: Optional[str] = None):
    """-> (model on `device`, in eval mode, config). `checkpoint` is a
    checkpoint directory of `SegTrainer` (`best/`, `iter_N/`), the port's
    or the JAX package's (state.msgpack alone, read through the
    `segmentor` or `segmentor_det` porter at the config's backbone
    shape); `variables` a JAX segmentor's
    {"params": ..., "batch_stats": ...} tree (numpy arrays); without
    either, the modules' own initialisation under `torch.manual_seed
    (seed)` (the global generator's state is restored after)."""
    cfg = merge_cli_overrides(load_config(config_path), list(overrides))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg, kernels=kernels)
    if checkpoint:
        model.load_state_dict(ckpt_lib.load_model_state(
            checkpoint, "cpu", module=model))
    elif variables is not None:
        porter, porter_kwargs = porter_of(model)
        load_jax_variables(model, porter, variables, **porter_kwargs)
    return model.to(device), cfg


def inference_segmentor(model: EncoderDecoder, image: np.ndarray,
                        crop: Optional[Tuple[int, int]] = None,
                        stride: Optional[Tuple[int, int]] = None,
                        return_logits: bool = False):
    """image (H, W, 3) float or uint8 RGB -> (H, W) int64 class map on the
    host; with `return_logits`, also the (1, H, W, C) float32 logits on the
    model's device. `crop` runs the sliding window (`stride` defaults to
    `crop`), else the whole image in one forward. A model that returns a
    tuple (the det-guided one: logits, det logits) gives its first item."""
    dev = next(model.parameters()).device
    img = Normalize()({"img": np.asarray(image)})["img"][None]

    def fwd(x):
        out = model(x)
        return out[0] if isinstance(out, tuple) else out

    with torch.inference_mode():
        x = torch.from_numpy(img).to(dev)
        if crop is not None:
            logits = slide_inference(fwd, x, tuple(crop),
                                     tuple(stride or crop))
        else:
            logits = fwd(x).float()
        seg = logits.argmax(-1)[0].cpu().numpy()
    return (seg, logits) if return_logits else seg


def show_result(image: np.ndarray, seg: np.ndarray,
                palette=DEFAULT_PALETTE, opacity: float = 0.5) -> np.ndarray:
    """Blend the class palette over the image (base.py:112-146 style)."""
    img = np.asarray(image, np.float32)
    color = np.zeros_like(img)
    for cls, rgb in enumerate(palette):
        color[seg == cls] = rgb
    out = img * (1 - opacity) + color * opacity
    return np.clip(out, 0, 255).astype(np.uint8)
