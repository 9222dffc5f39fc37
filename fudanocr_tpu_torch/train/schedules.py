"""LR schedules of the CTR projects (port of
fudanocr_tpu/train/schedules.py), as plain functions of the update
count: an optimizer step sets each `param_group["lr"]` from them. The
count starts at 0 for the first update, as optax's does.

* cosine warm restarts (OI-CTR / CCR-CLIP stage 2: torch
  CosineAnnealingWarmRestarts(T_0=10), orientation-independent-CTR/
  train.py:30);
* step decay x0.8 every 2 epochs after 10 (CCR-CLIP stage 1,
  main.py:113-116).

The JAX schedules compute in float32; these compute in float64 (Python
floats), within 1e-6 relative of them.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_warm_restarts(base_lr: float, t0: int, t_mult: int = 1,
                         eta_min: float = 0.0) -> Schedule:
    """SGDR; `t0` in updates (torch counts epochs: multiply by the updates
    per epoch)."""

    def schedule(step: int) -> float:
        if t_mult == 1:
            t_cur, t_i = step % t0, float(t0)
        else:   # the closed form of geometric restarts
            n = math.floor(math.log1p(step / t0 * (t_mult - 1))
                           / math.log(t_mult))
            t_cur = step - t0 * (t_mult ** n - 1) / (t_mult - 1)
            t_i = t0 * t_mult ** n
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t_cur / t_i))

    return schedule


def step_decay_after(base_lr: float, start_epoch: int = 10,
                     every: int = 2, factor: float = 0.8,
                     steps_per_epoch: int = 1) -> Schedule:
    """x`factor` every `every` epochs once past `start_epoch`."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        n = max(math.floor((epoch - start_epoch) / every), 0)
        return base_lr * factor ** n

    return schedule
