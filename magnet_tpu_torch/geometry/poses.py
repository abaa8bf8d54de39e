"""Relative camera poses with validity masking (numpy, host side).

The port's copy of ``magnet_tpu/geometry/poses.py``.

Vectorized equivalent of the reference's host-side python loop
(utils/utils.py:72-98): for each (batch, view), the neighbor->reference
relative pose is ``extM_nghbr @ inv(extM_ref)`` (both world->cam), and any
NaN in either extrinsic or the product invalidates the view. Validity is a
*mask array* consumed by the cost volume — never data-dependent control flow
(the reference's per-view `.item()` sync, homography.py:97, does not exist
here).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def relative_poses(ref_extM: np.ndarray,
                   nghbr_extMs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ref_extM: (B, 4, 4); nghbr_extMs: (B, V, 4, 4) world->cam matrices.

    Returns (nghbr_poses (B, V, 4, 4) float32, is_valid (B, V) float32).
    Invalid entries have pose == 0 (matching the reference's zeros init,
    utils/utils.py:78).
    """
    ref = np.asarray(ref_extM, dtype=np.float64)
    ngh = np.asarray(nghbr_extMs, dtype=np.float64)
    B, V = ngh.shape[:2]

    ref_ok = ~np.isnan(ref).any(axis=(1, 2))                       # (B,)
    ngh_ok = ~np.isnan(ngh).any(axis=(2, 3))                       # (B, V)

    # Pseudo-inverse path never raises; singular/NaN refs are masked out.
    ref_safe = np.where(ref_ok[:, None, None], ref, np.eye(4))
    try:
        ref_inv = np.linalg.inv(ref_safe)
    except np.linalg.LinAlgError:
        ref_inv = np.stack([np.linalg.pinv(m) for m in ref_safe])

    ngh_safe = np.nan_to_num(ngh)
    rel = np.einsum("bvij,bjk->bvik", ngh_safe, ref_inv)
    rel_ok = ~np.isnan(rel).any(axis=(2, 3))

    is_valid = (ref_ok[:, None] & ngh_ok & rel_ok)
    poses = np.where(is_valid[:, :, None, None], rel, 0.0)
    return poses.astype(np.float32), is_valid.astype(np.float32)


def split_rt(nghbr_poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, V, 4, 4) -> (R (B, V, 3, 3), t (B, V, 3)) (MAGNET.py:147-148)."""
    return nghbr_poses[:, :, :3, :3], nghbr_poses[:, :, :3, 3]
