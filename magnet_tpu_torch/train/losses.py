"""Training losses (reference utils/losses.py).

The port's copy of ``magnet_tpu/train/losses.py``. The reference indexes
valid pixels with boolean masks (losses.py:15-21,36-48); here, as in the JAX
package, masked means are weighted sums: identical values, static shapes.

Conventions: predictions NHWC with the channel pair on the last axis —
(mu, var) for D-Net, (mu, sigma) for MaGNet. Losses are computed in f32.
"""

from __future__ import annotations

from typing import Sequence

import torch

from magnet_tpu_torch.core import mesh
from magnet_tpu_torch.core.distributed import rank_world

_VAR_FLOOR = 1e-10


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of x over the mask. Under W ranks (``core/mesh.py``) the
    sum of this rank's share over the global batch's count, times W: the
    ranks' mean of these, and of their gradients, is the global batch's
    masked mean, as the JAX step takes it over the sharded batch."""
    m = mask.to(torch.float32)
    world = rank_world()[1]
    if world == 1:
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    count = torch.clamp(mesh.batch_total(torch.sum(m)), min=1.0)
    return torch.sum(x * m) * world / count


def gaussian_nll(mu: torch.Tensor, var: torch.Tensor,
                 gt: torch.Tensor) -> torch.Tensor:
    """Per-pixel Gaussian NLL: (mu-gt)^2/(2 var) + log(var)/2, var floored
    at 1e-10 (losses.py:19-21)."""
    var = torch.clamp(var.to(torch.float32), min=_VAR_FLOOR)
    mu = mu.to(torch.float32)
    gt = gt.to(torch.float32)
    return torch.square(mu - gt) / (2.0 * var) + 0.5 * torch.log(var)


def dnet_loss(pred: torch.Tensor, gt_depth: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """D-Net loss: masked mean NLL with (mu, var) channels
    (losses.py:13-22). pred: (B, H, W, 2); gt_depth, mask: (B, H, W)."""
    nll = gaussian_nll(pred[..., 0], pred[..., 1], gt_depth)
    return _masked_mean(nll, mask)


def magnet_loss(pred_list: Sequence[torch.Tensor], gt_depth: torch.Tensor,
                mask: torch.Tensor, gamma: float = 0.8) -> torch.Tensor:
    """Sequence loss over refinement iterations, weight gamma^(N-i-1),
    (mu, sigma) channels with var = sigma^2 (losses.py:34-50)."""
    n = len(pred_list)
    loss = 0.0
    for i, pred in enumerate(pred_list):
        w = gamma ** (n - i - 1)
        sigma = pred[..., 1].to(torch.float32)
        nll = gaussian_nll(pred[..., 0], torch.square(sigma), gt_depth)
        loss = loss + w * _masked_mean(nll, mask)
    return loss


def fnet_l1_loss(pred_depth: torch.Tensor, gt_depth: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """L1 between soft-argmax depth and (nearest-downsampled) GT at dpv
    resolution (train_FNet.py:100-106)."""
    l1 = torch.abs(pred_depth.to(torch.float32)
                   - gt_depth.to(torch.float32))
    return _masked_mean(l1, mask)


def soft_argmax_depth(cost_volume: torch.Tensor,
                      d_center: torch.Tensor) -> torch.Tensor:
    """Expected depth under the softmaxed sweep volume
    (train_FNet.py:96): (B, H, W, D) x (D,) -> (B, H, W)."""
    return torch.sum(cost_volume * d_center[None, None, None, :], dim=-1)
