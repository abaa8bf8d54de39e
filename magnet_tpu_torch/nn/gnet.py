"""G-Net: cost volume -> residual update of the depth Gaussian, PyTorch.

Counterpart of ``magnet_tpu/nn/gnet.py``. A 4-layer CNN maps
concat(cost volume, D-Net decoder feature) to an update in sigma-normalised
space: ``mu = mu0 + mu1 * sigma0``, ``sigma = (elu(sigma1) + 1 + 1e-10) *
sigma0``.

The parameters are the reference's: ``gnet = Sequential(conv3x3(D + 256 ->
128), ReLU, conv1x1, ReLU, conv1x1, ReLU, conv1x1(128 -> 2))``, so a
reference checkpoint loads natively (keys ``gnet.{0,2,4,6}``). The forward
slices the first conv along its input channels, as the JAX package stores
it: the cost-volume part (first D channels, no bias) and the feature part
(last 256, with the bias). The feature part does not change over the
refinement iterations: ``precompute_feature`` runs it once per frame through
``kernels.head_chain``; each iteration then is one launch of
``kernels.gnet_update``. Both keep their weights, and the kernels' operands,
on the module (``cached_fold``), so an iteration prepares nothing. In train
mode (MaGNet training) both run as plain convs in the feature's dtype, with
autograd, as the JAX package gates its kernels ``not train``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

import torch.nn.functional as F

from magnet_tpu_torch.kernels.gnet_update import gnet_operands, gnet_update
from magnet_tpu_torch.kernels.head_chain import head_chain, head_operands
from magnet_tpu_torch.nn.layers import cached_fold, conv2d, hwio, nchw, nhwc


class GNet(nn.Module):
    def __init__(self, n_samples: int = 5, feature_dim: int = 256,
                 hidden: int = 128, out_ch: int = 2):
        super().__init__()
        self.n_samples = n_samples
        self.gnet = nn.Sequential(
            nn.Conv2d(n_samples + feature_dim, hidden, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hidden, hidden, 1), nn.ReLU(),
            nn.Conv2d(hidden, hidden, 1), nn.ReLU(),
            nn.Conv2d(hidden, out_ch, 1))

    def precompute_feature(self, feat: torch.Tensor) -> torch.Tensor:
        """The decoder feature's term of the first layer, bias included.
        feat: (B, H, W, 256) -> (B, H, W, 128). Its weights and the kernel's
        operands are kept on the module (``cached_fold``)."""
        conv0 = self.gnet[0]
        if self.training:
            w = conv0.weight[:, self.n_samples:].to(feat.dtype)
            return nhwc(F.conv2d(nchw(feat), w, conv0.bias.to(feat.dtype),
                                 padding=1))

        def fold():
            w = hwio(conv0, feat.dtype)[:, :, self.n_samples:].contiguous()
            convs = [(w, conv0.bias, False)]
            return convs, (head_operands(convs) if feat.is_cuda else None)
        convs, operands = cached_fold(self, "feature_term", feat.dtype,
                                      list(conv0.parameters()), fold)
        return head_chain(feat, convs, operands)

    def forward(self, cost_volume: torch.Tensor, feat_contrib: torch.Tensor,
                ref_gaussian: torch.Tensor) -> torch.Tensor:
        """cost_volume: (B, H, W, D); feat_contrib: (B, H, W, 128) from
        ``precompute_feature``; ref_gaussian: (B, H, W, 2) = (mu0, sigma0).
        Returns the updated (mu, sigma), (B, H, W, 2)."""
        dt = feat_contrib.dtype
        conv0, _, conv1, _, conv2, _, conv3 = self.gnet
        if self.training:
            return self.train_forward(cost_volume, feat_contrib, ref_gaussian)

        def fold():
            w0 = hwio(conv0, dt)[:, :, :self.n_samples].contiguous()
            convs = [(w0, None)] + [(hwio(c, dt), c.bias)
                                    for c in (conv1, conv2, conv3)]
            return convs, (gnet_operands(convs) if feat_contrib.is_cuda
                           else None)
        convs, operands = cached_fold(
            self, "update", dt,
            [conv0.weight] + [t for c in (conv1, conv2, conv3)
                              for t in c.parameters()], fold)
        return gnet_update(cost_volume.to(dt).contiguous(), feat_contrib,
                           ref_gaussian.to(dt).contiguous(), convs, operands)

    def train_forward(self, cost_volume: torch.Tensor,
                      feat_contrib: torch.Tensor,
                      ref_gaussian: torch.Tensor) -> torch.Tensor:
        """The update as plain convs in the feature's dtype, the JAX
        package's ``GNet.__call__`` off its kernel: the cost-volume part of
        the first conv plus the feature term, ReLU, three 1x1 convs; then
        mu = mu0 + mu1 sigma0, sigma = (elu(sigma1) + 1 + 1e-10) sigma0
        (elu in f32) in ref_gaussian's dtype."""
        dt = feat_contrib.dtype
        conv0, _, conv1, _, conv2, _, conv3 = self.gnet
        w0 = conv0.weight[:, :self.n_samples].to(dt)
        y = F.conv2d(nchw(cost_volume.to(dt)), w0, padding=1)
        y = F.relu(y + nchw(feat_contrib))
        y = F.relu(conv2d(y, conv1))
        y = nhwc(conv2d(F.relu(conv2d(y, conv2)), conv3))
        mu0, sigma0 = ref_gaussian[..., 0:1], ref_gaussian[..., 1:2]
        mu = mu0 + y[..., 0:1] * sigma0
        sigma = (F.elu(y[..., 1:2].float()) + 1.0 + 1e-10).to(
            sigma0.dtype) * sigma0
        return torch.cat([mu, sigma], -1)
