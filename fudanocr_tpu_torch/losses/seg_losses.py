"""Segmentation losses of the train step: cross-entropy, Lovász-softmax and
accuracy (port of fudanocr_tpu/losses/seg_losses.py: `cross_entropy_loss`
:24-39, `lovasz_softmax_loss` :170-236 with `_lovasz_grad` :84-90,
`seg_accuracy` :239-244).

NHWC (B, H, W, C) logits and an integer (B, H, W) label map whose
`ignore_index` pixels count nothing. The Lovász extension sorts the
per-pixel errors: `torch.sort` (descending) gives the order, the Lovász
weights are computed on the sorted ground truth without gradient, and one
scatter puts them back in pixel order, so the loss is sum(errors * w) and
its gradient a broadcast multiply, as in JAX. Two or more exactly equal
errors may sort either way: the loss value does not depend on it, the
gradient does. The JAX `lovasz_softmax_bucketed` is a recorded negative
and is not ported.

In a data-parallel step (`core/mesh.data_parallel`) every loss is this
rank's share of the global batch's: the means divide by all-reduced
denominators, and Lovász, whose sort is global, gathers the errors and
labels of every rank in rank order (the global batch's pixel order),
forms the global weights with a stable sort, and dots its own errors with
its slice of them.
"""

from __future__ import annotations

from typing import Optional

import torch

from fudanocr_tpu_torch.core import mesh
from fudanocr_tpu_torch.nn.layers import at_least_f32


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weight: Optional[torch.Tensor] = None,
                       ignore_index: int = 255) -> torch.Tensor:
    """Mean negative log-likelihood over the valid pixels (fp32)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(at_least_f32(logits), -1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = valid.float()
    if class_weight is not None:
        w = w * class_weight[safe]
    return (nll * w).sum() / mesh.all_reduce_sum(w.sum()).clamp(min=1.0)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """The Lovász extension's weights of a ground truth sorted by
    descending error."""
    gts = gt_sorted.sum()
    inter = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jac = 1.0 - inter / union.clamp(min=1e-8)
    return torch.cat([jac[:1], jac[1:] - jac[:-1]])


def _weights_in_place(errors: torch.Tensor, *gts,
                      stable: bool = False) -> torch.Tensor:
    """Sort by descending error; the Lovász weights of each (ground truth,
    present) pair, 0 where the class is absent, summed and carried back to
    pixel order by one scatter. No host synchronisation."""
    order = torch.sort(errors.detach(), descending=True,
                       stable=stable).indices
    w = torch.zeros_like(errors.detach())
    for gt, present in gts:
        w = w + torch.where(present, _lovasz_grad(gt[order]),
                            torch.zeros((), device=w.device))
    return torch.zeros_like(w).scatter_(0, order, w)


def _global_weights(errors: torch.Tensor, *fgs) -> tuple:
    """(this rank's slice of the global Lovász weights, each class's
    global presence) in a data-parallel step: the ranks' errors and
    ground truths gathered in rank order, the global batch's pixel order,
    and sorted stably, so equal errors keep that order on any world size.
    One process's unstable sort may order equal errors otherwise: the loss
    value is the same, the gradients of the tied pixels may not be."""
    m = mesh.current()
    n = errors.shape[0]
    all_errors = mesh.all_gather(errors.detach())
    gts = [(g, g.sum() > 0) for g in (mesh.all_gather(fg) for fg in fgs)]
    w = _weights_in_place(all_errors, *gts, stable=True)
    return w[m.index * n:(m.index + 1) * n], [p for _, p in gts]


def lovasz_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = 255) -> torch.Tensor:
    """Lovász-softmax over all valid pixels, mean over present classes.

    Two classes (every textformer config) share one error vector,
    |fg1 - p1| = |fg0 - p0|, so one sort orders both classes (the JAX
    binary path :180-210); more classes sort per class (:212-236)."""
    c = logits.shape[-1]
    probs = torch.softmax(at_least_f32(logits), -1).reshape(-1, c)
    flat = labels.reshape(-1)
    valid = flat != ignore_index
    safe = torch.where(valid, flat, 0)
    zero = torch.zeros((), device=probs.device)

    if c == 2:
        fg0 = ((safe == 0) & valid).float()
        fg1 = ((safe == 1) & valid).float()
        errors = torch.where(valid, (fg0 - probs[:, 0]).abs(), zero)
        if mesh.current() is None:
            p0, p1 = fg0.sum() > 0, fg1.sum() > 0
            w = _weights_in_place(errors, (fg0, p0), (fg1, p1))
        else:
            w, (p0, p1) = _global_weights(errors, fg0, fg1)
        present = p0.float() + p1.float()
        return (errors * w).sum() / present.clamp(min=1.0)

    losses, present = [], []
    for ci in range(c):
        fg = ((safe == ci) & valid).float()
        errors = torch.where(valid, (fg - probs[:, ci]).abs(), zero)
        if mesh.current() is None:
            p = fg.sum() > 0
            w = _weights_in_place(errors, (fg, p))
        else:
            w, (p,) = _global_weights(errors, fg)
        loss_c = (errors * w).sum()
        losses.append(torch.where(p, loss_c, zero))
        present.append(p.float())
    return torch.stack(losses).sum() / torch.stack(present).sum().clamp(
        min=1.0)


def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
    """Share of valid pixels whose argmax class is the label."""
    valid = labels != ignore_index
    hit = ((logits.argmax(-1) == labels) & valid).float()
    return mesh.all_reduce_sum(hit.sum()) / mesh.all_reduce_sum(
        valid.float().sum()).clamp(min=1.0)
