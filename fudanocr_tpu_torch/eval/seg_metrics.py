"""Segmentation metrics: intersect_and_union histograms -> mIoU / mDice /
mFscore (port of fudanocr_tpu/eval/seg_metrics.py; reference
mmseg/core/evaluation/metrics.py:26-330).

`intersect_and_union` counts on the tensors' device with `torch.bincount`;
`total_metrics` turns the accumulated float64 histograms into the scores,
in numpy, as the JAX module does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def intersect_and_union(pred: torch.Tensor, label: torch.Tensor,
                        num_classes: int, ignore_index: int = 255):
    """-> (intersect, union, pred_area, label_area), each (num_classes,)
    int64 on the tensors' device."""
    valid = label != ignore_index
    pred = torch.where(valid, pred, num_classes).long()
    label = torch.where(valid, label, num_classes).long()

    def hist(x):
        return torch.bincount(x.reshape(-1),
                              minlength=num_classes + 1)[:num_classes]

    inter = hist(torch.where(pred == label, pred, num_classes))
    pred_area = hist(pred)
    label_area = hist(label)
    union = pred_area + label_area - inter
    return inter, union, pred_area, label_area


def total_metrics(inter: np.ndarray, union: np.ndarray,
                  pred_area: np.ndarray, label_area: np.ndarray,
                  beta: int = 1) -> Dict[str, np.ndarray]:
    """Accumulated histograms -> per-class IoU/Dice/F-score + aAcc."""
    eps = np.finfo(np.float64).eps
    iou = inter / np.maximum(union, eps)
    dice = 2 * inter / np.maximum(pred_area + label_area, eps)
    precision = inter / np.maximum(pred_area, eps)
    recall = inter / np.maximum(label_area, eps)
    fscore = ((1 + beta ** 2) * precision * recall
              / np.maximum(beta ** 2 * precision + recall, eps))
    acc = inter / np.maximum(label_area, eps)
    return {
        "aAcc": float(inter.sum() / max(label_area.sum(), eps)),
        "IoU": iou, "mIoU": float(np.nanmean(iou)),
        "Dice": dice, "mDice": float(np.nanmean(dice)),
        "Fscore": fscore, "mFscore": float(np.nanmean(fscore)),
        "Precision": precision, "Recall": recall,
        "Acc": acc, "mAcc": float(np.nanmean(acc)),
    }
