"""RAFT-style learned convex upsampling, NHWC.

Counterpart of ``magnet_tpu/ops/upsample.py``: each full-resolution output
pixel is a softmax-weighted convex combination of the 3x3 coarse
neighbourhood of its parent pixel. ``upsample_via_mask`` goes through
``kernels.upsample_mask``: the plain version for a tensor on the CPU, the
CUDA kernel for a tensor on the card, one launch for the maps that share a
mask.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from magnet_tpu_torch.kernels.upsample_mask import upsample_mask
from magnet_tpu_torch.ops.resample import resize_bilinear_align_corners

Maps = Union[torch.Tensor, Sequence[torch.Tensor]]


def upsample_via_mask(depth: Maps, up_mask: torch.Tensor, k: int) -> Maps:
    """depth: (B, H, W, C), or a sequence of such maps; up_mask:
    (B, H, W, 9*k*k). Returns (B, k*H, k*W, C) in depth's dtype (a list for
    a sequence), computed in f32."""
    if isinstance(depth, torch.Tensor):
        return upsample_mask(depth.contiguous(), up_mask.to(depth.dtype), k)
    maps = [d.contiguous() for d in depth]
    return upsample_mask(maps, up_mask.to(maps[0].dtype), k)


def upsample_bilinear(depth: torch.Tensor, up_mask, k: int) -> torch.Tensor:
    """Bilinear upsampling by k (align_corners=True)."""
    B, H, W, C = depth.shape
    return resize_bilinear_align_corners(depth, H * k, W * k)
