"""SR training losses: MSE + text focus (attention-map L1 + confusion-
weighted CE) (port of fudanocr_tpu/losses/sr_losses.py; reference
scene-text-telescope/loss/text_focus_loss.py:40-104 and
loss/weight_ce_loss.py:10-47).

The oracle is the frozen `OCRTransformer(vocab=37, num_in=1, layers=(1, 2,
5, 3), num_heads=16)`: `TextFocusLoss` puts it in eval mode with
`requires_grad_(False)`, and gradients still flow through its forward
into the SR image, as in the reference (eval()'d, not detached). Labels
are fixed-shape (B, Lmax) with a length mask; the CE and the map L1 are
masked means, as in the JAX package. Without a confusion table the
weighted CE is the plain CE. In a data-parallel step (`core/mesh`) each
term is this rank's share of the global batch's mean: its own sum over
the all-reduced denominator.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fudanocr_tpu_torch.core.mesh import all_reduce_sum, mean_share
from fudanocr_tpu_torch.eval.metrics import str_filt
from fudanocr_tpu_torch.nn.layers import at_least_f32

# '-' = 0 is both the start token and the padding index, as in the
# reference english_alphabet (text_focus_loss.py:47).
ENGLISH_ALPHABET = ("-0123456789abcdefghijklmnopqrstuvwxyz"
                    "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
LOSS_VOCAB = 37  # '-' + 0-9 + a-z (loss/transformer.py:8)


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """NHWC RGB -> single-channel luma (text_focus_loss.py:16-21)."""
    r, g, b = img[..., 0:1], img[..., 1:2], img[..., 2:3]
    return 0.299 * r + 0.587 * g + 0.114 * b


def encode_text_labels(labels, max_len: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side codec (text_focus_loss.py:62-81): filter to the 37-char
    vocabulary, append the '-' terminator, build the shift-right decoder
    input and the dense target grid.

    Returns (text_input [B, L], text_gt [B, L], lengths [B]), int32."""
    b = len(labels)
    text_input = np.zeros((b, max_len), dtype=np.int32)
    text_gt = np.zeros((b, max_len), dtype=np.int32)
    lengths = np.zeros((b,), dtype=np.int32)
    char_to_idx = {ch: i for i, ch in enumerate(ENGLISH_ALPHABET)}
    for i, raw in enumerate(labels):
        s = (str_filt(raw, "lower") + "-")[:max_len]
        ids = [char_to_idx[ch] for ch in s]
        lengths[i] = len(ids)
        text_gt[i, :len(ids)] = ids
        # decoder input: start token (0) then the label shifted right
        text_input[i, 1:len(ids)] = ids[:-1]
    return text_input, text_gt, lengths


def weighted_cross_entropy(pred: torch.Tensor, gt: torch.Tensor,
                           mask: torch.Tensor,
                           weight_table: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Confusion-weighted CE (weight_ce_loss.py:37-46), masked mean.

    pred (B, L, C) logits, gt (B, L) ids, mask (B, L) {0, 1}:
    loss_i = -log(w[gt_i, gt_i] exp(p_gt) / sum_j w[gt_i, j] exp(p_j))."""
    logp = at_least_f32(pred)
    gt = gt.long()
    if weight_table is not None:
        logp = logp + weight_table[gt].clamp_min(1e-20).log()
    nll = logp.logsumexp(-1) - logp.gather(-1, gt[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / all_reduce_sum(mask.sum()).clamp_min(1.0)


def load_confuse_weight_table(path: str) -> np.ndarray:
    """Rearrange the raw 62x62 confusion counts into the 37x37 inverse-
    frequency weight table (weight_ce_loss.py:10-33). The file is a
    pickle: load only tables from a trusted source."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    number, upper, lower = data[:10], data[10:36], data[36:]
    end = np.ones((1, 62))
    pad = np.ones((63, 1))
    re = np.concatenate((end, number, lower, upper), axis=0)
    re = np.concatenate((pad, re), axis=1)
    with np.errstate(divide="ignore"):
        re = 1.0 / re
    re[np.isinf(re)] = 1.0
    lower_alpha = "abcdefghijklmnopqrstuvwxyz"
    for i in range(63):
        for j in range(63):
            if i != j and ENGLISH_ALPHABET[j] in lower_alpha:
                re[i][j] = max(re[i][j], re[i][j + 26])
    return re[:37, :37].astype(np.float32)


class TextFocusLoss:
    """mse + 10 * L1(oracle attention maps, HR vs SR) + 5e-4 * weighted CE
    of the oracle's predictions on SR.

    `oracle` is an OCRTransformer (or None with `text_focus=False`, which
    leaves plain MSE); it is frozen here. `weight_table` is the optional
    (37, 37) confusion table (`load_confuse_weight_table`)."""

    def __init__(self, oracle: Optional[torch.nn.Module],
                 weight_table: Optional[np.ndarray] = None,
                 text_focus: bool = True):
        self.oracle = oracle
        if oracle is not None:
            oracle.eval().requires_grad_(False)
        self.weight_table = (None if weight_table is None
                             else torch.as_tensor(weight_table,
                                                  dtype=torch.float32))
        self.text_focus = text_focus

    def hr_oracle_map(self, hr: torch.Tensor,
                      text_input: torch.Tensor) -> torch.Tensor:
        """The HR branch of the loss: the frozen oracle's attention map on
        the constant (hr, text_input) pair. It is a pure function of the
        sample, so callers may compute it once per sample and pass it back
        as `hr_map` (SRTrainer's cache)."""
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
        sr_out = self.oracle(to_gray(sr), text_input)

        l = text_gt.shape[1]
        mask = (torch.arange(l, device=lengths.device)[None, :]
                < lengths[:, None])
        map_mask = mask[:, None, :, None].float()            # (B, 1, L, 1)
        map_diff = (at_least_f32(hr_map)
                    - at_least_f32(sr_out["map"])).abs() * map_mask
        denom = (all_reduce_sum(map_mask.sum()).clamp_min(1.0)
                 * hr_map.shape[1] * hr_map.shape[3])
        attention_loss = map_diff.sum() / denom
        wt = (None if self.weight_table is None
              else self.weight_table.to(sr.device))
        recognition_loss = weighted_cross_entropy(sr_out["pred"], text_gt,
                                                  mask, wt)
        total = mse + attention_loss * 10.0 + recognition_loss * 0.0005
        return total, {"mse": mse, "attention": attention_loss,
                       "recognition": recognition_loss}
