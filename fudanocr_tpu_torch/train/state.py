"""The SR recipe's optimizer (port of fudanocr_tpu/train/state.py:
`adam_with_clip`, optax `chain(clip_by_global_norm(clip), adam(lr, b1,
b2))`; reference interfaces/base.py:194-199, super_resolution.py:79-84).

The global-norm clip is written as optax writes it: the gradients are
scaled by clip / norm only when norm >= clip (torch's `clip_grad_norm_`
divides by norm + 1e-6 and so differs). The scale is computed on the
device, with no host synchronisation. Adam is `torch.optim.Adam`, whose
update (bias-corrected moments, eps outside the square root) is optax's.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


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
