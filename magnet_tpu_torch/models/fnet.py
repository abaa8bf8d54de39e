"""F-Net: matching-feature extractor, PyTorch.

Counterpart of ``magnet_tpu/models/fnet.py``: (B, H, W, 3) -> features
(B, H/4, W/4, feature_dim), NHWC. The only architecture is 'PSM-Net';
``stream_blocks`` runs its stride-1 BasicBlocks one launch each
(``nn.psmnet``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from magnet_tpu_torch.nn.psmnet import PSMNet


class FNet(nn.Module):
    def __init__(self, architecture: str = "PSM-Net", feature_dim: int = 64,
                 stream_blocks: bool = False):
        super().__init__()
        if architecture != "PSM-Net":
            raise ValueError(f"unknown F-Net arch {architecture!r}")
        self.f_net = PSMNet(feature_dim, stream_blocks)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.f_net(img)
