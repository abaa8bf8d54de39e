"""Optimizer and schedules of F-Net training.

The port of ``magnet_tpu/train/optim.py`` (``onecycle``, ``onecycle_beta1``,
``_clip``, ``_adamw``, ``make_fnet_optimizer``), which chains optax
transforms: an elementwise clip at 1e6, a clip by global norm, then AdamW
(weight decay 0.01 on every parameter, BatchNorm's included) whose learning
rate and beta1 follow one-cycle schedules evaluated at the step count before
the update. Here that is ``torch.optim.AdamW`` with its learning rate and
beta1 set from the schedules before each step, after a clip written out:

* ``onecycle`` is optax's ``cosine_onecycle_schedule``, whose phase
  boundaries sit at ``int(pct_start * T)`` and ``T`` with T floored at 4
  (torch's ``OneCycleLR`` puts them at ``pct_start * T - 1`` and ``T - 1``);
  it is computed in double precision, optax in f32;
* ``onecycle_beta1`` follows torch's convention, as the JAX package does;
* the global-norm clip scales by ``max / norm`` with no epsilon, as
  ``optax.clip_by_global_norm`` does (``clip_grad_norm_`` adds 1e-6).

torch's AdamW decays the weights before the Adam step, optax adds the decay
to the update: ``p - lr * (adam + wd * p)`` either way, from the same ``p``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import numpy as np
import torch

# Elementwise pre-clip before the global-norm clip: squaring a pathological
# gradient for the norm could overflow f32 to inf and poison Adam's moments.
PRE_CLIP = 1e6
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

Schedule = Callable[[int], float]


def onecycle(peak_lr: float, total_steps: int, div_factor: float = 25.0,
             final_div_factor: float = 10000.0,
             pct_start: float = 0.3) -> Schedule:
    """Cosine one-cycle learning rate: peak / div_factor up to peak over
    ``int(pct_start * T)`` steps, then down to peak / (div_factor *
    final_div_factor) at T, with T = max(total_steps, 4) (a shorter T makes
    optax's warmup segment empty and its 0/0 turns the schedule NaN)."""
    T = max(total_steps, 4)
    bounds = [0, int(pct_start * T), int(T)]
    values = np.cumprod([peak_lr / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0
                             * (math.cos(math.pi * pct) + 1))
        return float(values[-1])

    return schedule


def onecycle_beta1(total_steps: int, pct_start: float = 0.3,
                   base_momentum: float = 0.85,
                   max_momentum: float = 0.95) -> Schedule:
    """torch OneCycleLR's momentum cycle: beta1 anneals max -> base over the
    learning rate's warmup and base -> max over the rest, cosine in both
    phases, in anti-phase with the learning rate."""
    up_steps = float(max(pct_start * max(total_steps, 1) - 1, 1))
    down_steps = float(max((max(total_steps, 1) - 1) - up_steps, 1))

    def cos_anneal(start, end, pct):
        pct = min(max(pct, 0.0), 1.0)
        return end + (start - end) / 2.0 * (1 + math.cos(math.pi * pct))

    def schedule(step: int) -> float:
        if step <= up_steps:
            return cos_anneal(max_momentum, base_momentum, step / up_steps)
        return cos_anneal(base_momentum, max_momentum,
                          (step - up_steps) / down_steps)

    return schedule


def clip_(grads: List[torch.Tensor], grad_clip: float) -> None:
    """In place: clip every element to +-PRE_CLIP, then, where the global
    norm is not below ``grad_clip``, scale by ``grad_clip / norm``."""
    for g in grads:
        g.clamp_(-PRE_CLIP, PRE_CLIP)
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < grad_clip
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * grad_clip))


class ScheduledAdamW:
    """The optax chain of the JAX package's ``make_fnet_optimizer``: clip,
    then AdamW at the schedules' values for the current step. ``count`` is
    the number of updates made, the schedules' position."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr_schedule: Schedule, beta1_schedule: Schedule,
                 weight_decay: float, grad_clip: float):
        self.params = list(params)
        self.lr_schedule = lr_schedule
        self.beta1_schedule = beta1_schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr_schedule(0),
            betas=(beta1_schedule(0), ADAM_B2), eps=ADAM_EPS,
            weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        clip_(grads, self.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr_schedule(self.count)
            group["betas"] = (self.beta1_schedule(self.count), ADAM_B2)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_fnet_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                        total_steps: int, weight_decay: float = 0.01,
                        grad_clip: float = 1.0, div_factor: float = 25.0,
                        final_div_factor: float = 10000.0,
                        beta1_cycle: bool = True) -> ScheduledAdamW:
    """One group: AdamW with one-cycle learning rate and beta1
    (train_FNet.py:45-48); ``beta1_cycle=False`` keeps beta1 at 0.9."""
    sched = onecycle(lr, total_steps, div_factor, final_div_factor)
    b1 = onecycle_beta1(total_steps) if beta1_cycle else (lambda step: 0.9)
    return ScheduledAdamW(params, sched, b1, weight_decay, grad_clip)
