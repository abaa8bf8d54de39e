"""Optimizers and schedules of the three training stages.

The port of ``magnet_tpu/train/optim.py`` (``onecycle``, ``onecycle_beta1``,
``_clip``, ``_adamw``, ``make_{dnet,fnet,magnet}_optimizer``), which chains
optax transforms: an elementwise clip at 1e6, a clip by global norm, then
AdamW (weight decay 0.01 on every parameter it updates, BatchNorm's
included) whose learning rate and beta1 follow one-cycle schedules evaluated
at the step count before the update; ``multi_transform`` gives the D-Net's
encoder its own learning rate and sets a frozen group's update to zero (no
step, no weight decay). The clip comes first, so a frozen parameter's
gradient still counts in the global norm. Here that is
``torch.optim.AdamW`` over the updated groups, each group's learning rate
and beta1 set from the schedules before each step, after a clip written out
over every gradient, the frozen ones' included:

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
from typing import Callable, Iterable, List, Sequence, Tuple

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


Groups = Sequence[Tuple[Iterable[torch.nn.Parameter], Schedule]]


class ScheduledAdamW:
    """The optax chain of the JAX package's optimizers: clip every gradient
    (those of ``frozen`` too), then AdamW on each of ``groups`` (parameters,
    learning-rate schedule) at the schedules' values for the current step;
    ``frozen`` parameters are never updated. ``count`` is the number of
    updates made, the schedules' position."""

    def __init__(self, groups: Groups, beta1_schedule: Schedule,
                 weight_decay: float, grad_clip: float,
                 frozen: Iterable[torch.nn.Parameter] = ()):
        groups = [(list(ps), sched) for ps, sched in groups]
        self.params = [p for ps, _ in groups for p in ps] + list(frozen)
        self.lr_schedules = [sched for _, sched in groups]
        self.beta1_schedule = beta1_schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.adamw = torch.optim.AdamW(
            [dict(params=ps, lr=sched(0)) for ps, sched in groups],
            betas=(beta1_schedule(0), ADAM_B2), eps=ADAM_EPS,
            weight_decay=weight_decay)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        clip_(grads, self.grad_clip)
        for group, sched in zip(self.adamw.param_groups, self.lr_schedules):
            group["lr"] = sched(self.count)
            group["betas"] = (self.beta1_schedule(self.count), ADAM_B2)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def _beta1(total_steps: int, beta1_cycle: bool) -> Schedule:
    return onecycle_beta1(total_steps) if beta1_cycle else (lambda step: 0.9)


def make_fnet_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                        total_steps: int, weight_decay: float = 0.01,
                        grad_clip: float = 1.0, div_factor: float = 25.0,
                        final_div_factor: float = 10000.0,
                        beta1_cycle: bool = True) -> ScheduledAdamW:
    """One group: AdamW with one-cycle learning rate and beta1
    (train_FNet.py:45-48); ``beta1_cycle=False`` keeps beta1 at 0.9."""
    sched = onecycle(lr, total_steps, div_factor, final_div_factor)
    return ScheduledAdamW([(params, sched)], _beta1(total_steps, beta1_cycle),
                          weight_decay, grad_clip)


def make_dnet_optimizer(model: torch.nn.Module, lr: float, total_steps: int,
                        weight_decay: float = 0.01, grad_clip: float = 1.0,
                        same_lr: bool = False, div_factor: float = 25.0,
                        final_div_factor: float = 10000.0,
                        freeze_encoder: bool = False,
                        beta1_cycle: bool = True) -> ScheduledAdamW:
    """Two groups (train_DNet.py:48-53): the parameters of ``model`` whose
    name holds "encoder" at lr / 10 (lr with ``same_lr``), the rest at lr.
    With ``freeze_encoder`` (AdaBins_fix) the encoder is never updated, but
    its gradients still count in the clip's global norm, as in the JAX
    package's chain."""
    enc, rest = [], []
    for name, p in model.named_parameters():
        (enc if "encoder" in name.split(".") else rest).append(p)
    sched = onecycle(lr, total_steps, div_factor, final_div_factor)
    sched_enc = onecycle(lr if same_lr else lr / 10, total_steps,
                         div_factor, final_div_factor)
    groups = [(rest, sched)] if freeze_encoder else [(enc, sched_enc),
                                                     (rest, sched)]
    return ScheduledAdamW(groups, _beta1(total_steps, beta1_cycle),
                          weight_decay, grad_clip,
                          frozen=enc if freeze_encoder else ())


def make_magnet_optimizer(model: torch.nn.Module, lr: float,
                          total_steps: int, weight_decay: float = 0.01,
                          grad_clip: float = 1.0, div_factor: float = 25.0,
                          final_div_factor: float = 10000.0,
                          beta1_cycle: bool = True) -> ScheduledAdamW:
    """One group of ``g_net.*`` and ``mask_head.*`` (MAGNET.py:82-92); the
    D-Net and F-Net are frozen. Their gradients are never taken
    (``Magnet.encode``), so the clip's norm is that of the trained
    parameters, as in the JAX package, where they are zero."""
    train = [p for name, p in model.named_parameters()
             if name.split(".")[0] in ("g_net", "mask_head")]
    sched = onecycle(lr, total_steps, div_factor, final_div_factor)
    return ScheduledAdamW([(train, sched)], _beta1(total_steps, beta1_cycle),
                          weight_decay, grad_clip)
