"""The F-Net training step.

The port of ``magnet_tpu/train/steps.py::TrainState`` and
``make_fnet_train_step``: ground truth clamped (depth above the maximum ->
0, mask = depth above the minimum), the forward in the compute dtype, the L1
loss on the soft-argmax depth, the backward, the clipped AdamW update.
BatchNorm's running buffers are updated by the train-mode forward, as the
JAX step takes its new ``batch_stats`` from the same forward. Geometry and
the sweep depths stay f32.

Dtype policy: f32 master weights, compute in ``--compute_dtype``. The JAX
step casts the images and every floating parameter (BatchNorm's scale and
bias included) with ``core/dtypes.py::cast_floating``; BatchNorm then
computes in f32 from those rounded values, and its running statistics are
not cast. The port casts the images here and mirrors the rest with explicit
casts in the forwards (a conv's weight to the activation dtype, BatchNorm's
scale and bias to the activation dtype and back to f32,
``nn.layers.batch_norm_train``), so that gradients flow through the casts
back to the f32 masters.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from magnet_tpu_torch.train import losses
from magnet_tpu_torch.train.optim import ScheduledAdamW
from magnet_tpu_torch.utils.profiling import stage

Batch = Dict[str, torch.Tensor]


class TrainState:
    """What a training run carries from step to step: the step count, the
    model (parameters and BatchNorm buffers), the optimizer (moments and the
    schedules' position) and a generator seeded from ``seed``."""

    def __init__(self, model: torch.nn.Module, optimizer: ScheduledAdamW,
                 seed: int = 0):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.generator = torch.Generator().manual_seed(seed)


def make_fnet_train_step(d_center: torch.Tensor, max_depth: float,
                         min_depth: float,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Callable[[TrainState, Batch],
                                       Tuple[TrainState, Dict]]:
    """batch: ref_img (B, H, W, 3), src_imgs (B, V, H, W, 3), R, t,
    is_valid, intM, rays2d, and depth_dpv (B, h, w), the ground truth
    nearest-downsampled to the cost volume on the host; on the model's
    device. d_center: (D,) f32 there too. After the step each parameter's
    ``.grad`` holds its clipped gradient."""

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        gt = batch["depth_dpv"]
        gt = torch.where(gt > max_depth, torch.zeros_like(gt), gt)
        mask = gt > min_depth
        model = state.model.train()
        cv = model(batch["ref_img"].to(compute_dtype),
                   batch["src_imgs"].to(compute_dtype), batch["R"],
                   batch["t"], batch["is_valid"], batch["intM"],
                   batch["rays2d"], d_center)
        with stage("soft-argmax + L1"):
            pred = losses.soft_argmax_depth(cv, d_center)
            loss = losses.fnet_l1_loss(pred, gt, mask)
        state.optimizer.zero_grad()
        with stage("backward"):
            loss.backward()
        with stage("clip + AdamW"):
            state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step
