"""D-Net: single-view Gaussian depth model, PyTorch.

Counterpart of ``magnet_tpu/models/dnet.py``. ``DNet`` wraps DenseDepth with
the output activation of ``output_type``: 'R' raw, 'G' Gaussian
(mu, var = elu(v) + 1 + 1e-10). ``DNetCoarse`` is MaGNet's internal
variant: coarse (mu, sigma = sqrt(var)) and the 256-channel decoder
feature. Tensors are NHWC; the channel pair is the last axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from magnet_tpu_torch.nn.densedepth import DenseDepth


def activation_gaussian(out: torch.Tensor) -> torch.Tensor:
    """(..., 2) raw -> (mu, var) with var = elu(v) + 1 + 1e-10."""
    mu = out[..., 0:1]
    var = F.elu(out[..., 1:2].float()) + 1.0 + 1e-10
    return torch.cat([mu, var.to(out.dtype)], dim=-1)


def activation_gaussian_stdev(out: torch.Tensor) -> torch.Tensor:
    """(..., 2) raw -> (mu, sigma) with sigma = sqrt(elu(v) + 1 + 1e-10)."""
    mu = out[..., 0:1]
    sigma = torch.sqrt(F.elu(out[..., 1:2].float()) + 1.0 + 1e-10)
    return torch.cat([mu, sigma.to(out.dtype)], dim=-1)


class DNet(nn.Module):
    """Standalone D-Net: (B, H, W, 3) -> (B, H, W, output_dim).
    ``use_bn`` chooses the BatchNorm or the GroupNorm decoder;
    ``mbconv_chain`` and ``dw_kernel`` switch the trunk's kernels,
    ``remat`` recomputes its blocks and stages in the backward
    (``nn.densedepth``). Train mode (stage 1) draws the trunk's drop-path
    masks from ``generator``."""

    def __init__(self, output_dim: int = 2, output_type: str = "G",
                 downsample_ratio: int = 4, mbconv_chain=None,
                 dw_kernel: bool = False, remat: bool = False,
                 use_bn: bool = True):
        super().__init__()
        self.output_type = output_type
        self.d_net = DenseDepth(num_classes=output_dim,
                                downsample_ratio=downsample_ratio,
                                learned_upsampling=True, as_dnet=True,
                                mbconv_chain=mbconv_chain,
                                dw_kernel=dw_kernel, remat=remat,
                                use_bn=use_bn)

    def forward(self, img: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        out = self.d_net(img, generator)
        if self.output_type == "G":
            return activation_gaussian(out)
        return out


class DNetCoarse(nn.Module):
    """MaGNet-internal D-Net: coarse (mu, sigma) + decoder feature."""

    def __init__(self, output_dim: int = 2, downsample_ratio: int = 4,
                 mbconv_chain=None, dw_kernel: bool = False,
                 use_bn: bool = True):
        super().__init__()
        self.d_net = DenseDepth(num_classes=output_dim,
                                downsample_ratio=downsample_ratio,
                                learned_upsampling=True, as_dnet=False,
                                mbconv_chain=mbconv_chain,
                                dw_kernel=dw_kernel, use_bn=use_bn)

    def forward(self, img: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        depth, feat = self.d_net(img)
        return activation_gaussian_stdev(depth), feat
