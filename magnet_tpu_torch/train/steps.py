"""The training steps of the three stages.

The port of ``magnet_tpu/train/steps.py``: ``TrainState``, the D-Net step
(stage 1), the F-Net step (stage 2), the MaGNet batch loss and step (stage
3) and the evaluation forwards. Each step clamps the ground truth (depth
above the maximum -> 0, mask = depth above the minimum), runs the forward in
the compute dtype, takes the stage's loss, the backward and the clipped
AdamW update. BatchNorm's running buffers are updated by the train-mode
forward, as the JAX step takes its new ``batch_stats`` from the same
forward; stage 3 updates none (its backbones run in eval mode). Geometry
and the sweep depths stay f32.

Under a process group of W ranks (``core/distributed.py``) each rank runs
the step on its share of the global batch: BatchNorm takes the global
batch's statistics, the gradients are averaged over the ranks before the
clip and the reported loss is the ranks' mean, as the JAX step on a sharded
batch (``core/mesh.py``). The steps are not wrapped in DDP: ``Magnet``'s
step calls ``encode`` and ``fuse``, which would bypass its hooks.

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

from magnet_tpu_torch.core import mesh
from magnet_tpu_torch.train import losses
from magnet_tpu_torch.train.optim import ScheduledAdamW
from magnet_tpu_torch.utils.profiling import stage

Batch = Dict[str, torch.Tensor]


class TrainState:
    """What a training run carries from step to step: the step count, the
    model (parameters and BatchNorm buffers), the optimizer (moments and the
    schedules' position) and a generator seeded from ``seed`` on the model's
    device (the D-Net's drop-path masks)."""

    def __init__(self, model: torch.nn.Module, optimizer: ScheduledAdamW,
                 seed: int = 0):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        device = next(model.parameters()).device
        self.generator = torch.Generator(device).manual_seed(seed)


def _clamped_gt(depth: torch.Tensor, max_depth: float, min_depth: float):
    """The ground truth with depth above the maximum zeroed, and its mask of
    depths above the minimum (train_DNet.py:81-82)."""
    gt = torch.where(depth > max_depth, torch.zeros_like(depth), depth)
    return gt, gt > min_depth


def _update(state: TrainState, loss: torch.Tensor) -> Dict:
    """Backward, the gradients averaged over the ranks (``core/mesh.py``:
    the frozen encoder's too, which count in the clip norm), clip and AdamW,
    one step further. Returns the step's metrics: the loss, averaged over
    the ranks."""
    state.optimizer.zero_grad()
    with stage("backward"):
        loss.backward()
    with stage("gradient all-reduce"):
        mesh.average_gradients(state.model.parameters())
    with stage("clip + AdamW"):
        state.optimizer.step()
    state.step += 1
    return {"loss": mesh.mean_over_ranks(loss.detach())}


def make_dnet_train_step(max_depth: float, min_depth: float,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Callable[[TrainState, Batch],
                                       Tuple[TrainState, Dict]]:
    """batch: img (B, H, W, 3), depth (B, H, W), on the model's device. The
    D-Net (``DNet``) in train mode (train BatchNorm, drop path from the
    state's generator) on the images in ``compute_dtype``, the Gaussian NLL
    on its (mu, var), then the clipped AdamW update."""

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        with stage("D-Net step"):
            gt, mask = _clamped_gt(batch["depth"], max_depth, min_depth)
            model = state.model.train()
            with stage("D-Net forward"):
                out = model(batch["img"].to(compute_dtype), state.generator)
            with stage("loss"):
                loss = losses.dnet_loss(out, gt, mask)
            return state, _update(state, loss)

    return step


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
        with stage("F-Net step"):
            gt, mask = _clamped_gt(batch["depth_dpv"], max_depth, min_depth)
            model = state.model.train()
            cv = model(batch["ref_img"].to(compute_dtype),
                       batch["src_imgs"].to(compute_dtype), batch["R"],
                       batch["t"], batch["is_valid"], batch["intM"],
                       batch["rays2d"], d_center)
            with stage("soft-argmax + L1"):
                pred = losses.soft_argmax_depth(cv, d_center)
                loss = losses.fnet_l1_loss(pred, gt, mask)
            return state, _update(state, loss)

    return step


MAGNET_INPUTS = ("ref_img", "src_imgs", "R", "t", "is_valid", "intM",
                 "rays2d")


def magnet_batch_loss(model: torch.nn.Module, batch: Batch, gamma: float,
                      max_depth: float, min_depth: float, n_iters: int,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """The stage-3 loss of one batch: the ground truth clamped, the whole
    forward (images in ``compute_dtype``) and the gamma-weighted NLL over
    its iterations. batch: the inputs of ``Magnet.forward`` and depth
    (B, H, W). ``model`` in train mode takes the training path."""
    preds = model(batch["ref_img"].to(compute_dtype),
                  batch["src_imgs"].to(compute_dtype),
                  *[batch[k] for k in MAGNET_INPUTS[2:]], n_iters=n_iters)
    with stage("loss"):
        return magnet_preds_loss(preds, batch["depth"], gamma, max_depth,
                                 min_depth)


def magnet_preds_loss(preds, depth: torch.Tensor, gamma: float,
                      max_depth: float, min_depth: float) -> torch.Tensor:
    """The gamma-weighted NLL of the upsampled iterations ``preds`` against
    the clamped ground truth ``depth`` (B, H, W)."""
    gt, mask = _clamped_gt(depth, max_depth, min_depth)
    return losses.magnet_loss(preds, gt, mask, gamma)


def make_magnet_train_step(gamma: float, max_depth: float, min_depth: float,
                           n_iters: int,
                           compute_dtype: torch.dtype = torch.float32
                           ) -> Callable[[TrainState, Batch],
                                         Tuple[TrainState, Dict]]:
    """The stage-3 step: ``Magnet`` in train mode (G-Net and the mask head
    train, the D-Net and F-Net stay frozen in eval mode), the batch loss,
    then the clipped AdamW update of ``make_magnet_optimizer``."""

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        with stage("MaGNet step"):
            model = state.model.train()
            loss = magnet_batch_loss(model, batch, gamma, max_depth,
                                     min_depth, n_iters, compute_dtype)
            return state, _update(state, loss)

    return step


def make_dnet_eval_fn(model: torch.nn.Module):
    """img -> the D-Net's output, in eval mode without autograd; the model
    is back in its mode after."""
    @torch.inference_mode()
    def forward(img: torch.Tensor) -> torch.Tensor:
        was = model.training
        try:
            return model.eval()(img)
        finally:
            model.train(was)
    return forward


def make_magnet_eval_fn(model: torch.nn.Module, n_iters: int,
                        return_all: bool = False):
    """batch -> the last iteration's (B, H, W, 2) = (mu, sigma), with
    ``return_all`` the list of every iteration's (the training dumps show
    each one), in eval mode without autograd; the model is back in its mode
    after."""
    @torch.inference_mode()
    def forward(batch: Batch):
        was = model.training
        try:
            preds = model.eval()(*[batch[k] for k in MAGNET_INPUTS],
                                 n_iters=n_iters)
            return preds if return_all else preds[-1]
        finally:
            model.train(was)
    return forward
