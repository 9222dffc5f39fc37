"""Segmentation losses: cross-entropy, Dice, focal, Tversky, Lovász-softmax
(exact and bucketed) and accuracy (port of fudanocr_tpu/losses/
seg_losses.py: `cross_entropy_loss` :24-39, `dice_loss` :42-53,
`focal_loss` :56-65, `tversky_loss` :68-81, `lovasz_softmax_bucketed`
:93-167, `lovasz_softmax_loss` :170-236 with `_lovasz_grad` :84-90,
`seg_accuracy` :239-244).

NHWC (B, H, W, C) logits and an integer (B, H, W) label map whose
`ignore_index` pixels count nothing. The Lovász extension sorts the
per-pixel errors: `torch.sort` (descending) gives the order, the Lovász
weights are computed on the sorted ground truth without gradient, and one
scatter puts them back in pixel order, so the loss is sum(errors * w) and
its gradient a broadcast multiply, as in JAX. Two or more exactly equal
errors may sort either way: the loss value does not depend on it, the
gradient does. `lovasz_softmax_bucketed` (binary only, the train step's
`lovasz_impl="bucketed"`) orders the errors by K buckets instead of a
sort: K-bin histograms (one scatter-add; JAX compares a P x K one-hot,
8.6 GB at the det recipe's P) give each bucket's Lovász weight.

In a data-parallel step (`core/mesh.data_parallel`) every loss is this
rank's share of the global batch's: the means divide by all-reduced
denominators, and Lovász, whose sort is global, gathers the errors and
labels of every rank in rank order (the global batch's pixel order),
forms the global weights with a stable sort, and dots its own errors with
its slice of them. The bucketed Lovász all-reduces its histograms and the
class totals instead (integer counts: exact), and dots its own errors with
the global bucket weights. Dice and Tversky are per-image (JAX's sums run
over the spatial axes) means over the batch and classes.
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


def _probs_onehot(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int) -> tuple:
    """(softmax probabilities, one-hot labels), both zero at ignored
    pixels, in float32 (float64 kept), and the spatial axes to sum."""
    c = logits.shape[-1]
    valid = (labels != ignore_index)[..., None]
    probs = torch.softmax(at_least_f32(logits), -1) * valid
    onehot = torch.nn.functional.one_hot(
        torch.where(valid[..., 0], labels, 0).long(), c).to(probs.dtype) \
        * valid
    return probs, onehot, tuple(range(1, logits.ndim - 1))


def _one_minus_mean(x: torch.Tensor) -> torch.Tensor:
    """1 - x.mean(), or this rank's share of it in a data-parallel step."""
    if mesh.current() is None:
        return 1.0 - x.mean()
    return mesh.mean_share(1.0 - x)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              smooth: float = 1.0, ignore_index: int = 255) -> torch.Tensor:
    """1 - the mean over images and classes of (2|P∩G| + s) / (|P| + |G| +
    s), P the softmax, G the one-hot labels, over the valid pixels."""
    probs, onehot, dims = _probs_onehot(logits, labels, ignore_index)
    inter = (probs * onehot).sum(dims)
    denom = probs.sum(dims) + onehot.sum(dims)
    return _one_minus_mean((2 * inter + smooth) / (denom + smooth))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.25,
               ignore_index: int = 255) -> torch.Tensor:
    """Mean over the valid pixels of alpha (1 - p_t)^gamma (-log p_t)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(at_least_f32(logits), -1)
    lp = logp.gather(-1, safe[..., None])[..., 0]
    loss = alpha * (1.0 - lp.exp()) ** gamma * -lp
    w = valid.to(loss.dtype)
    return (loss * w).sum() / mesh.all_reduce_sum(w.sum()).clamp(min=1.0)


def tversky_loss(logits: torch.Tensor, labels: torch.Tensor,
                 alpha: float = 0.3, beta: float = 0.7, smooth: float = 1.0,
                 ignore_index: int = 255) -> torch.Tensor:
    """1 - the mean over images and classes of (TP + s) / (TP + alpha FP +
    beta FN + s) on the softmax, over the valid pixels."""
    probs, onehot, dims = _probs_onehot(logits, labels, ignore_index)
    tp = (probs * onehot).sum(dims)
    fp = (probs * (1 - onehot)).sum(dims)
    fn = ((1 - probs) * onehot).sum(dims)
    return _one_minus_mean((tp + smooth)
                           / (tp + alpha * fp + beta * fn + smooth))


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


def _bucket_weights(g: torch.Tensor, cnt: torch.Tensor,
                    gts: torch.Tensor) -> torch.Tensor:
    """The Lovász weight of one pixel of each bucket (JAX's
    `bucket_weights`): the Jaccard loss telescopes over the cumulative
    counts, so bucket k's total weight is jac(C_k) - jac(C_k-1), shared by
    its cnt_k pixels."""
    cg = g.cumsum(0)
    inter = gts - cg
    union = gts + (cnt.cumsum(0) - cg)
    jac = 1.0 - inter / union.clamp(min=1e-8)
    return torch.cat([jac[:1], jac[1:] - jac[:-1]]) / cnt.clamp(min=1.0)


def lovasz_softmax_bucketed(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_index: int = 255,
                            num_buckets: int = 1024) -> torch.Tensor:
    """Sort-free Lovász-softmax of two classes: the exact Lovász value of
    the errors ordered by `num_buckets` levels, the weights spread evenly
    within a bucket. It equals `lovasz_softmax_loss` where no two distinct
    errors share a bucket.

    The bucket of an error e is (k-1) - clip(int(e (k-1) + 0.5), 0, k-1)
    in float32, as JAX forms it (bucket 0 the largest errors). The counts
    per bucket come from one scatter-add, not JAX's P x K one-hot: they
    are integers below 2^24, so exactly JAX's."""
    c = logits.shape[-1]
    if c != 2:
        raise ValueError(f"the bucketed Lovász takes two classes, not {c}")
    k = num_buckets
    probs = torch.softmax(at_least_f32(logits), -1).reshape(-1, c)
    flat = labels.reshape(-1)
    valid = flat != ignore_index
    safe = torch.where(valid, flat, 0)
    fg0 = ((safe == 0) & valid).to(probs.dtype)
    fg1 = ((safe == 1) & valid).to(probs.dtype)
    errors = torch.where(valid, (fg0 - probs[:, 0]).abs(),
                         torch.zeros((), dtype=probs.dtype,
                                     device=probs.device))
    e32 = errors.detach().float()
    b = (k - 1) - (e32 * (k - 1) + 0.5).to(torch.int32).clamp(0, k - 1)
    b = b.long()
    # (count, fg0, valid) per bucket, then the class totals
    hist = torch.zeros((3, k), dtype=probs.dtype, device=probs.device)
    hist.scatter_add_(1, b.expand(3, -1),
                      torch.stack([torch.ones_like(fg0), fg0,
                                   valid.to(probs.dtype)]))
    totals = torch.stack([fg0.sum(), fg1.sum()])
    if mesh.current() is not None:
        both = mesh.all_reduce_sum(torch.cat([hist.reshape(-1), totals]))
        hist, totals = both[:3 * k].view(3, k), both[3 * k:]
    cnt, g0, vk = hist
    p0, p1 = totals > 0
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    wbar = (torch.where(p0, _bucket_weights(g0, cnt, totals[0]), zero)
            + torch.where(p1, _bucket_weights(vk - g0, cnt, totals[1]),
                          zero))
    loss = (errors * wbar[b]).sum()
    return loss / (p0.to(loss.dtype) + p1.to(loss.dtype)).clamp(min=1.0)


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
