"""Camera intrinsics rescaling and unit-ray arrays (numpy, host side).

The port's copy of ``magnet_tpu/geometry/rays.py``.

Vectorized (numpy, host-side; tiny) equivalents of the per-sample code in the
reference ScanNet loader (data/dataloader_scannet.py:113-153): intrinsics are
rescaled from the raw capture resolution to the cost-volume (dpv) resolution,
and a per-pixel unit ray array K^-1 @ (u+0.5, v+0.5, 1) is built at dpv
resolution, flattened to (3, H*W).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pixel_center_grid(height: int, width: int) -> np.ndarray:
    """(H, W, 3) homogeneous pixel-center coordinates (u+0.5, v+0.5, 1)."""
    grid = np.ones((height, width, 3), dtype=np.float64)
    grid[:, :, 0] = np.arange(width)[None, :] + 0.5
    grid[:, :, 1] = np.arange(height)[:, None] + 0.5
    return grid


def rescale_intrinsics(K_raw: np.ndarray, raw_w: float, raw_h: float,
                       out_w: int, out_h: int) -> np.ndarray:
    """Scale a 3x3 (or 4x4 upper-left) intrinsic matrix from raw capture
    resolution to (out_w, out_h)."""
    K = np.zeros((3, 3), dtype=np.float64)
    K[2, 2] = 1.0
    K[0, 0] = K_raw[0, 0] * (out_w / raw_w)
    K[1, 1] = K_raw[1, 1] * (out_h / raw_h)
    K[0, 2] = K_raw[0, 2] * (out_w / raw_w)
    K[1, 2] = K_raw[1, 2] * (out_h / raw_h)
    return K


def unit_ray_array_2d(K_raw: np.ndarray, raw_w: float, raw_h: float,
                      dpv_w: int, dpv_h: int) -> np.ndarray:
    """(3, H*W) array of rays through dpv pixel centers, expressed with the
    *raw* intrinsics (the reference scales dpv pixel centers back to raw
    resolution before applying K_raw^-1; dataloader_scannet.py:140-147)."""
    grid = pixel_center_grid(dpv_h, dpv_w)
    rays = np.copy(grid)
    rays[:, :, 0] = (grid[:, :, 0] * (raw_w / dpv_w) - K_raw[0, 2]) / K_raw[0, 0]
    rays[:, :, 1] = (grid[:, :, 1] * (raw_h / dpv_h) - K_raw[1, 2]) / K_raw[1, 1]
    rays2d = rays.transpose(2, 0, 1).reshape(3, -1)
    return rays2d.astype(np.float32)


def intrinsics_for_dpv(K_raw: np.ndarray, raw_w: float, raw_h: float,
                       dpv_w: int, dpv_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (intM (3,3) float32, unit_ray_array_2D (3, H*W) float32) —
    the `cam_intrins` pair consumed by the cost volume."""
    K = rescale_intrinsics(K_raw, raw_w, raw_h, dpv_w, dpv_h)
    rays2d = unit_ray_array_2d(K_raw, raw_w, raw_h, dpv_w, dpv_h)
    return K.astype(np.float32), rays2d
