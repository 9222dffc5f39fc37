"""Stroke-focus loss (Text Gestalt, AAAI-22; port of
fudanocr_tpu/losses/stroke_focus.py, reference text-gestalt/loss/
stroke_focus_loss.py:20-125).

MSE plus `stroke_lambda` x the length-masked L1 between the stroke-level
attention maps of a frozen stroke-decomposition transformer run on HR and
on SR (the reference disables its recognition CE). The oracle is the
shared `OCRTransformer` with vocab 10 (stroke digits) and a 1-channel
encoder. The interface is `TextFocusLoss`'s (`oracle`, `text_focus`,
`hr_oracle_map`), so `SRTrainer`'s HR-map cache serves it unchanged; in
a data-parallel step its means are shares of the global batch's, as
there.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fudanocr_tpu_torch.core.mesh import all_reduce_sum, mean_share
from fudanocr_tpu_torch.losses.sr_losses import to_gray
from fudanocr_tpu_torch.nn.layers import at_least_f32


class StrokeFocusLoss:
    """`oracle` is frozen here (eval mode, no parameter gradients;
    gradients still flow through its forward into the SR image)."""

    def __init__(self, oracle: Optional[torch.nn.Module],
                 stroke_lambda: float = 50.0, text_focus: bool = True):
        self.oracle = oracle
        if oracle is not None:
            oracle.eval().requires_grad_(False)
        self.stroke_lambda = stroke_lambda
        self.text_focus = text_focus

    def hr_oracle_map(self, hr: torch.Tensor,
                      text_input: torch.Tensor) -> torch.Tensor:
        """The frozen oracle's attention map on (hr, text_input), a pure
        function of the sample (cacheable, see TextFocusLoss)."""
        with torch.no_grad():
            return self.oracle(to_gray(hr), text_input)["map"]

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor,
                 text_input: torch.Tensor, text_gt: torch.Tensor,
                 lengths: torch.Tensor,
                 hr_map: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mse = mean_share((at_least_f32(sr) - at_least_f32(hr)) ** 2)
        if not self.text_focus:
            return mse, {"mse": mse}
        if hr_map is None:
            hr_map = self.hr_oracle_map(hr, text_input)
        sr_map = self.oracle(to_gray(sr), text_input)["map"]

        l = text_gt.shape[1]
        mask = (torch.arange(l, device=lengths.device)[None, :]
                < lengths[:, None])
        map_mask = mask[:, None, :, None].float()            # (B, 1, L, 1)
        diff = (at_least_f32(hr_map) - at_least_f32(sr_map)).abs() * map_mask
        denom = (all_reduce_sum(map_mask.sum()).clamp_min(1.0)
                 * hr_map.shape[1] * hr_map.shape[3])
        attention_loss = diff.sum() / denom
        total = mse + attention_loss * self.stroke_lambda
        return total, {"mse": mse, "attention": attention_loss}
