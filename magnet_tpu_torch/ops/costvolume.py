"""The fixed plane-sweep cost volume of F-Net training, with its gradient.

Counterpart of ``magnet_tpu/ops/costvolume.py::cost_volume_sweep`` and its
custom VJP (``_sweep_pre_cost``): every reference pixel is matched against
each source view at D fixed sweep depths (the candidate projected into the
view, the view's feature sampled bilinearly with zeros outside, dotted with
the reference feature), the valid views are summed and divided by their
number, and the result is softmaxed over D.

Forward: the consistency-weighted cost volume kernel
(``kernels.cost_volume_cw``) with the consistency test switched off
(mu = 0, sigma = 1e30, kappa = 1: every in-image sample passes, and a sample
wholly outside interpolates sigma to 0 and contributes 0, as the gather
does) and every pixel's candidates the sweep depths; it returns the
pre-softmax cost already divided by V.

Backward (``SweepCost``): the cotangent of the pre-softmax sum is the
incoming one divided by V. The source features' gradient is the transpose of
the bilinear warp, ``kernels.sweep_grad_src``; the reference features'
gradient is a re-gather, sum over views and planes of ``gbar * valid *
sampled_src``, ``kernels.sweep_grad_ref`` (the JAX package leaves it to XLA).
On the card each is one CUDA kernel launch. Depths, poses, validity,
intrinsics and rays get no gradient.
"""

from __future__ import annotations

import torch

from magnet_tpu_torch.kernels.cost_volume_cw import cost_volume_cw
from magnet_tpu_torch.kernels.sweep_grad_ref import sweep_grad_ref
from magnet_tpu_torch.kernels.sweep_grad_src import sweep_grad_src
from magnet_tpu_torch.utils.profiling import stage

# sigma of the forward: |z - 0| < 1e30 * (sum of in-image weights) holds for
# every sample that touches the map
NO_CHECK_SIGMA = 1e30


def sweep_forward_args(d_center: torch.Tensor, ref_feat: torch.Tensor,
                       src_feat: torch.Tensor, R: torch.Tensor,
                       t: torch.Tensor, is_valid: torch.Tensor,
                       intM: torch.Tensor, rays2d: torch.Tensor) -> list:
    """The arguments of ``cost_volume_cw`` that make it the pre-softmax
    sweep cost divided by V: every pixel's candidates the sweep depths
    (B, H, W, D), mu 0, sigma ``NO_CHECK_SIGMA``, kappa 1."""
    B, V, H, W, _ = src_feat.shape
    f32 = torch.float32
    dvol = d_center.to(f32).expand(B, H, W, d_center.shape[0])
    mu = torch.zeros((B, V, H, W), dtype=f32, device=src_feat.device)
    return [dvol, ref_feat, src_feat, mu, torch.full_like(mu, NO_CHECK_SIGMA),
            R, t, is_valid, intM, rays2d, 1.0]


class SweepCost(torch.autograd.Function):
    """The sweep cost (B, H, W, D) f32 before the softmax, divided by V;
    differentiable in ``ref_feat`` and ``src_feat``."""

    @staticmethod
    def forward(ctx, d_center, ref_feat, src_feat, R, t, is_valid, intM,
                rays2d):
        ctx.save_for_backward(d_center, ref_feat, src_feat, R, t, is_valid,
                              intM, rays2d)
        return cost_volume_cw(*sweep_forward_args(
            d_center, ref_feat, src_feat, R, t, is_valid, intM, rays2d))

    @staticmethod
    def backward(ctx, grad):
        d_center, ref_feat, src_feat, R, t, is_valid, intM, rays2d = \
            ctx.saved_tensors
        gbar = grad.to(torch.float32) / float(src_feat.shape[1])
        grad_ref = grad_src = None
        if ctx.needs_input_grad[1]:
            with stage("sweep backward: grad_ref (plain re-gather)"):
                grad_ref = sweep_grad_ref(d_center, src_feat, gbar, R, t,
                                          is_valid, intM, rays2d
                                          ).to(ref_feat.dtype)
        if ctx.needs_input_grad[2]:
            with stage("sweep backward: grad_src (row-10 kernel)"):
                grad_src = sweep_grad_src(d_center, ref_feat, gbar, R, t,
                                          is_valid, intM, rays2d
                                          ).to(src_feat.dtype)
        return None, grad_ref, grad_src, None, None, None, None, None


def cost_volume_sweep(d_center: torch.Tensor, ref_feat: torch.Tensor,
                      src_feat: torch.Tensor, R: torch.Tensor,
                      t: torch.Tensor, is_valid: torch.Tensor,
                      intM: torch.Tensor, rays2d: torch.Tensor
                      ) -> torch.Tensor:
    """d_center: (D,) sweep depths; ref_feat: (B, H, W, C); src_feat:
    (B, V, H, W, C); R: (B, V, 3, 3); t: (B, V, 3); is_valid: (B, V); intM:
    (B, 3, 3); rays2d: (B, 3, H*W). Returns (B, H, W, D) f32, softmaxed over
    D."""
    cost = SweepCost.apply(d_center, ref_feat, src_feat, R, t, is_valid,
                           intM, rays2d)
    return torch.softmax(cost, dim=-1)
