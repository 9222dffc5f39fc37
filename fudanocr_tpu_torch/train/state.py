"""The training recipes' optimizers.

* SR (port of fudanocr_tpu/train/state.py: `adam_with_clip`, optax
  `chain(clip_by_global_norm(clip), adam(lr, b1, b2))`; reference
  interfaces/base.py:194-199, super_resolution.py:79-84). The global-norm
  clip is written as optax writes it: the gradients are scaled by
  clip / norm only when norm >= clip (torch's `clip_grad_norm_` divides by
  norm + 1e-6 and so differs). The scale is computed on the device, with
  no host synchronisation.
* Segmentation (`SegAdam`, the update of fudanocr_tpu/train/seg.py:48-73
  `make_seg_optimizer`): per top-level subtree, optax
  `chain(add_decayed_weights(wd, mask=ndim > 1), scale_by_adam(0.9, 0.999),
  scale_by_schedule(-mult * schedule))`, mult 10 for the decode head. The
  decay is added to the gradient before Adam normalises it: Adam with a
  coupled L2 term, which `torch.optim.Adam(weight_decay=...)` is (the
  reference's decoupled AdamW is another update; ROADMAP Queue C9).

Adam is `torch.optim.Adam`, whose update (bias-corrected moments, eps
outside the square root) is optax's.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn


class AdamWithClip:
    """Global-norm clip, then Adam, over the parameters that require
    gradients. Call `zero_grad()`, backward, then `step()`."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 beta1: float = 0.5, beta2: float = 0.999,
                 clip: Optional[float] = 0.25, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.clip = clip
        self.adam = torch.optim.Adam(self.params, lr=lr,
                                     betas=(beta1, beta2), eps=eps)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def clip_gradients(self) -> Optional[torch.Tensor]:
        """Scale the gradients in place; returns their global norm before
        the clip (None when no parameter has a gradient)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return None
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        if self.clip is not None:
            scale = (self.clip / norm).clamp(max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        return norm

    def step(self) -> Optional[torch.Tensor]:
        """Clip, then one Adam update; returns the pre-clip global norm."""
        norm = self.clip_gradients()
        self.adam.step()
        return norm


def adam_with_clip(params: Iterable[torch.nn.Parameter], lr: float,
                   beta1: float = 0.5, beta2: float = 0.999,
                   clip: Optional[float] = 0.25) -> AdamWithClip:
    """The SR recipe: Adam(lr, beta1 0.5) after a global-norm clip of 0.25."""
    return AdamWithClip(params, lr, beta1, beta2, clip)


HEAD_MODULES = ("decode_head", "auxiliary_head")   # lr x head_lr_mult


class SegAdam:
    """Adam over four parameter groups (backbone or head, x decayed or
    not) with the lr set before each update to mult * schedule(count),
    count being the number of updates already taken (optax
    `scale_by_schedule`). Decay `weight_decay` applies to tensors with more
    than one dimension, coupled as in JAX. Call `zero_grad()`, backward,
    then `step()`."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float = 0.01, head_lr_mult: float = 10.0):
        self.schedule = schedule
        groups = {}
        for name, p in model.named_parameters():
            if p.requires_grad:
                head = name.split(".")[0] in HEAD_MODULES
                groups.setdefault((head, p.dim() > 1), []).append(p)
        self.adam = torch.optim.Adam(
            [{"params": ps, "weight_decay": weight_decay if decay else 0.0,
              "lr_mult": head_lr_mult if head else 1.0}
             for (head, decay), ps in sorted(groups.items())],
            lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
        self.count = 0
        self.last_lr = None

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> float:
        """One update at lr mult * schedule(count); returns schedule(count)
        (also kept in `last_lr`)."""
        lr = float(self.schedule(self.count))
        for group in self.adam.param_groups:
            group["lr"] = group["lr_mult"] * lr
        self.adam.step()
        self.count += 1
        self.last_lr = lr
        return lr
