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
  reference's decoupled AdamW is another update; ROADMAP Queue C9). The
  layer-wise decay optimizer (train/seg.make_layer_decay_optimizer) is the
  same update with a multiplier per parameter name (`lr_mult`).

* CTR (`ctr_adadelta`, fudanocr_tpu/train/ctr.py:91-94 and
  apps/oictr/train.py:118-126): optax `chain(add_decayed_weights(wd),
  adadelta(lr, rho=0.9, eps=1e-6))`, the lr a constant or a schedule of
  the update count. `torch.optim.Adadelta(weight_decay=wd)` adds the
  decay to the gradient first, then optax's update: E[g^2] and E[dx^2]
  with rho, dx = sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) * g.
* CCR-CLIP stage 1 (`clip_adam`, apps/ccr_clip/pretrain.py:80-82): optax
  `adam(lr, b1=0.9, b2=0.98, eps=1e-6)`.

Adam is `torch.optim.Adam`, whose update (bias-corrected moments, eps
outside the square root) is optax's.

`SegAdam`'s state crosses to the JAX optimizer's and back
(`jax_opt_state`, `load_jax_opt_state`), the state that JAX's
`SegTrainer` keeps in its periodic checkpoints. optax's state of
`multi_transform({"backbone", "head"})` over that chain is, in flax's
state-dict form,

  inner_states/{backbone,head}/inner_state/
      0/inner_state = {}             (the masked decay: no state)
      1/{count, mu, nu}              (scale_by_adam)
      2/count                        (scale_by_schedule)

where each group's mu and nu are params-shaped, the other group's
top-level subtrees empty maps (optax's MaskedNode). The moments cross
through the model's porter by parameter name, as the gradients do
(`utils/weights.grad_state_dict`): exp_avg is mu, exp_avg_sq nu, torch's
per-parameter step Adam's count, `ScheduledOptimizer.count` the
schedule's. The port groups parameters by (lr multiplier, decay), JAX by
top-level subtree with a decay mask inside; names, not group positions,
tie the two. The other optimizers' state (Adadelta, CLIP's Adam) has no
JAX checkpoint to cross to: the JAX package saves none.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from fudanocr_tpu_torch.utils.weights import (export_state_dict, porter_of,
                                              to_jax_variables)


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
        with_grad = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in with_grad]
        if not grads:
            return None
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
        groups = [getattr(p, "model_group", None) for p in with_grad]
        if any(g is not None for g in groups):
            norms = _whole_norms(norms, groups)
        norm = torch.linalg.vector_norm(torch.stack(norms))
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


def _whole_norms(norms: list, groups: list) -> list:
    """Each parameter's gradient norm over the whole parameter: a shard's
    (its `model_group` set, parallel/tp.TensorParallel) from the squares
    summed over its group in one all-reduce; a replicated one's as it is,
    counted once."""
    at = [i for i, g in enumerate(groups) if g is not None]
    sq = torch.stack([norms[i] ** 2 for i in at])
    dist.all_reduce(sq, group=groups[at[0]])
    out = list(norms)
    for i, s in zip(at, sq.sqrt()):
        out[i] = s
    return out


def adam_with_clip(params: Iterable[torch.nn.Parameter], lr: float,
                   beta1: float = 0.5, beta2: float = 0.999,
                   clip: Optional[float] = 0.25) -> AdamWithClip:
    """The SR recipe: Adam(lr, beta1 0.5) after a global-norm clip of 0.25."""
    return AdamWithClip(params, lr, beta1, beta2, clip)


HEAD_MODULES = ("decode_head", "auxiliary_head")   # lr x head_lr_mult


class ScheduledOptimizer:
    """A torch optimizer whose groups' lr is set before each update to the
    group's `lr_mult` (1 where it has none) times schedule(count), count
    being the number of updates already taken (optax `scale_by_schedule`).
    Call `zero_grad()`, backward, then `step()`."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0
        self.last_lr = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> float:
        """One update at schedule(count); returns that lr (also kept in
        `last_lr`)."""
        lr = float(self.schedule(self.count))
        for group in self.optimizer.param_groups:
            group["lr"] = group.get("lr_mult", 1.0) * lr
        self.optimizer.step()
        self.count += 1
        self.last_lr = lr
        return lr

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


class SegAdam(ScheduledOptimizer):
    """Adam over parameter groups (lr multiplier x decayed or not) under
    `schedule`. The multiplier of a parameter is `lr_mult(name)`, by
    default `head_lr_mult` for the decode head's and 1 for the rest. Decay
    `weight_decay` applies to tensors with more than one dimension,
    coupled as in JAX."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float = 0.01, head_lr_mult: float = 10.0,
                 lr_mult: Optional[Callable[[str], float]] = None):
        self.jax_layout = lr_mult is None   # JAX's two-group optimizer
        if lr_mult is None:
            lr_mult = lambda name: (head_lr_mult if name.split(".")[0]
                                    in HEAD_MODULES else 1.0)
        groups = {}
        for name, p in model.named_parameters():
            if p.requires_grad:
                groups.setdefault((lr_mult(name), p.dim() > 1), []).append(p)
        super().__init__(torch.optim.Adam(
            [{"params": ps, "weight_decay": weight_decay if decay else 0.0,
              "lr_mult": mult}
             for (mult, decay), ps in sorted(groups.items())],
            lr=schedule(0), betas=(0.9, 0.999), eps=1e-8), schedule)

    @property
    def adam(self) -> torch.optim.Adam:
        return self.optimizer

    def _check_jax_layout(self) -> None:
        if not self.jax_layout:
            raise NotImplementedError(
                "only the two-group optimizer (make_seg_optimizer) has a "
                "JAX checkpoint layout; JAX's trainer saves no other")

    def jax_opt_state(self, model: nn.Module) -> Dict[str, Any]:
        """The optax state of JAX's `make_seg_optimizer` that this state
        is (see the module docstring), numpy leaves. A parameter that has
        no Adam state yet has zero moments, as in JAX; the parameters'
        steps must agree."""
        self._check_jax_layout()
        sd = model.state_dict()
        mu, nu, steps = dict(sd), dict(sd), set()
        for name, p in model.named_parameters():
            st = self.adam.state.get(p)
            if st:
                mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
                steps.add(int(st["step"]))
            else:
                mu[name] = nu[name] = torch.zeros_like(p)
        if len(steps) > 1:
            raise ValueError(f"parameters at different Adam steps {steps}: "
                             "JAX keeps one count")
        count = np.asarray(steps.pop() if steps else 0, np.int32)
        porter, porter_kwargs = porter_of(model)
        mu = to_jax_variables(mu, porter, **porter_kwargs)["params"]
        nu = to_jax_variables(nu, porter, **porter_kwargs)["params"]

        def group(g):
            masked = lambda t: {k: v if _jax_group(k) == g else {}
                                for k, v in t.items()}
            return {"inner_state": {
                "0": {"inner_state": {}},
                "1": {"count": count, "mu": masked(mu), "nu": masked(nu)},
                "2": {"count": np.asarray(self.count, np.int32)}}}

        return {"inner_states": {g: group(g) for g in ("backbone", "head")}}

    def load_jax_opt_state(self, model: nn.Module, opt_state: Dict,
                           batch_stats: Dict) -> None:
        """Take the optax state `opt_state` of JAX's `make_seg_optimizer`
        (flax's state-dict form, as a checkpoint holds it) over `model`,
        whose checkpoint's `batch_stats` complete the porter's tree. Every
        count must agree; at count 0 no parameter has Adam state."""
        self._check_jax_layout()
        groups = {g: opt_state["inner_states"][g]["inner_state"]
                  for g in ("backbone", "head")}
        counts = {int(groups[g][i]["count"]) for g in groups
                  for i in ("1", "2")}
        if len(counts) != 1:
            raise ValueError(f"the optimizer state's counts disagree: "
                             f"{sorted(counts)}")
        count = counts.pop()
        template = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        porter, porter_kwargs = porter_of(model)

        def moments(which):
            tree = {k: groups[_jax_group(k)]["1"][which][k]
                    for k in groups["backbone"]["1"][which]}
            return export_state_dict(porter, {"params": tree,
                                              "batch_stats": batch_stats},
                                     template, **porter_kwargs)

        mu, nu = moments("mu"), moments("nu")
        names = {p: n for n, p in model.named_parameters()}
        saved = self.adam.state_dict()
        state, idx = {}, 0
        for group in self.adam.param_groups:
            for p in group["params"]:
                if count:
                    state[idx] = {
                        "step": torch.tensor(float(count)),
                        "exp_avg": mu[names[p]].to(p.device, p.dtype),
                        "exp_avg_sq": nu[names[p]].to(p.device, p.dtype)}
                idx += 1
        self.adam.load_state_dict({"state": state,
                                   "param_groups": saved["param_groups"]})
        self.count = count


def _jax_group(top_key: str) -> str:
    """The JAX seg optimizer's label of a top-level params subtree."""
    return "head" if top_key in HEAD_MODULES else "backbone"


def _schedule(lr) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda count: lr)


def ctr_adadelta(params: Iterable[torch.nn.Parameter], lr,
                 weight_decay: float = 0.0) -> ScheduledOptimizer:
    """The CTR recipe: decay `weight_decay` added to the gradients, then
    Adadelta(rho 0.9, eps 1e-6) at `lr`, a float or a schedule of the
    update count."""
    params = [p for p in params if p.requires_grad]
    return ScheduledOptimizer(
        torch.optim.Adadelta(params, lr=1.0, rho=0.9, eps=1e-6,
                             weight_decay=weight_decay), _schedule(lr))


def clip_adam(params: Iterable[torch.nn.Parameter],
              lr) -> ScheduledOptimizer:
    """CCR-CLIP pretraining: Adam(b1 0.9, b2 0.98, eps 1e-6) at `lr`, a
    float or a schedule of the update count."""
    params = [p for p in params if p.requires_grad]
    return ScheduledOptimizer(
        torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.98), eps=1e-6),
        _schedule(lr))
