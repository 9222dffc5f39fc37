"""CLIP symmetric contrastive loss with duplicate-aware targets (port of
fudanocr_tpu/losses/clip_loss.py).

image-ids-CTR/CCR-CLIP/main.py:98-106: the target of sample i is the index
of the FIRST batch element with the same label (font-rendered char batches
hold duplicates); the loss is the mean of the image->text and
text->image cross-entropies over the one device's batch (the JAX
package's sharded form is ROADMAP C5).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def first_occurrence_targets(labels: Sequence[str]) -> np.ndarray:
    """Host side: gt[i] = the first j with labels[j] == labels[i]."""
    seen = {}
    out = np.zeros(len(labels), dtype=np.int32)
    for i, lab in enumerate(labels):
        out[i] = seen.setdefault(lab, i)
    return out


def clip_symmetric_ce(image_features: torch.Tensor,
                      text_features: torch.Tensor,
                      logit_scale: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """(CE(s * I T^T, targets) + CE((s * I T^T)^T, targets)) / 2, with
    (B, D) features and (B,) int targets."""
    logits = logit_scale * image_features @ text_features.T
    targets = targets.long()
    return (F.cross_entropy(logits, targets)
            + F.cross_entropy(logits.T, targets)) / 2.0
