"""Resampling ops, NHWC at the boundary.

Counterpart of ``magnet_tpu/ops/resample.py``:
``resize_bilinear_align_corners`` equals ``F.interpolate(mode="bilinear",
align_corners=True)``; ``bilinear_gather`` samples one map at continuous
pixel coordinates with the semantics of ``F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=False)``; ``avg_pool`` is
``nn.AvgPool2d`` with ``ceil_mode=False``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True. x: (N, H, W, C); computed in
    f32, returned in x's dtype."""
    if x.shape[1] == out_h and x.shape[2] == out_w:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(out_h, out_w),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def bilinear_gather(feat: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (H, W, C) at continuous pixel coordinates (x, y) in
    index space ((0, 0) is the centre of the top-left pixel), bilinearly,
    with zeros outside the map. x, y: any one shape P...; returns
    (P..., C) f32."""
    H, W, C = feat.shape
    flat = feat.reshape(H * W, C).float()
    x, y = x.float(), y.float()
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    out = 0.0
    for cy in (0, 1):
        for cx in (0, 1):
            xi, yi = x0 + cx, y0 + cy
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            w = (wy1 if cy else 1.0 - wy1) * (wx1 if cx else 1.0 - wx1) * inb
            at = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            out = out + flat[at] * w[..., None]
    return out


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """AvgPool2d(window, stride) without padding, floor sizing. x:
    (N, H, W, C); computed in f32, returned in x's dtype."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), window, stride)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
