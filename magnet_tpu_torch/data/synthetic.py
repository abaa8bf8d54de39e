"""Synthetic datasets: procedurally generated images, smooth depth maps and
(multi-view) small random camera motion with consistent intrinsics and ray
arrays, so the evaluation and training paths run end to end without data
on disk. The port's copy of ``magnet_tpu/data/synthetic.py``: the same seed
gives the same frames in both packages. Each item draws from its own index;
the ``rng`` that ``base.Loader`` passes is taken and ignored, as it is
there.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from magnet_tpu_torch.data import base
from magnet_tpu_torch.data.scannet import _pack_multiview
from magnet_tpu_torch.geometry import rays as rays_lib


def _smooth_noise(rng, h, w, octaves=3):
    out = np.zeros((h, w), np.float32)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        coarse = rng.randn(sh, sw).astype(np.float32)
        ys = np.linspace(0, sh - 1, h)
        xs = np.linspace(0, sw - 1, w)
        y0 = np.clip(ys.astype(int), 0, sh - 2)
        x0 = np.clip(xs.astype(int), 0, sw - 2)
        wy = (ys - y0)[:, None]
        wx = (xs - x0)[None, :]
        v = (coarse[y0][:, x0] * (1 - wy) * (1 - wx)
             + coarse[y0][:, x0 + 1] * (1 - wy) * wx
             + coarse[y0 + 1][:, x0] * wy * (1 - wx)
             + coarse[y0 + 1][:, x0 + 1] * wy * wx)
        out += v / (2 ** o)
    return out


def _small_pose(rng, rot_scale=0.02, t_scale=0.05):
    w = rng.randn(3) * rot_scale
    th = np.linalg.norm(w) + 1e-12
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.randn(3) * t_scale
    return T


class SyntheticMultiView:
    def __init__(self, args):
        self.length = args.synthetic_length
        self.img_w, self.img_h = args.input_width, args.input_height
        self.dpv_w, self.dpv_h = args.dpv_width, args.dpv_height
        self.n_views = args.MAGNET_num_source_views
        self.center = self.n_views // 2

    def __len__(self):
        return self.length

    def get(self, idx: int, rng=None) -> Dict:
        rng = np.random.RandomState(idx)
        H, W = self.img_h, self.img_w
        fx = 0.9 * W
        K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
        intM, rays2d = rays_lib.intrinsics_for_dpv(
            K, W, H, self.dpv_w, self.dpv_h)
        depth = 2.5 + _smooth_noise(rng, H, W)
        depth = np.clip(depth, 0.5, 9.5).astype(np.float32)
        imgs, extMs = [], []
        for i in range(self.n_views + 1):
            tex = np.stack([_smooth_noise(rng, H, W) for _ in range(3)], -1)
            img = np.clip(0.5 + 0.25 * tex, 0, 1).astype(np.float32)
            imgs.append(base.normalize_image(img))
            extMs.append(np.eye(4) if i == self.center
                         else _small_pose(rng))
        # every sample draws its own frames, so every view id is unique
        return _pack_multiview(imgs, extMs, depth, self.center, intM,
                               rays2d, "synthetic", str(idx),
                               frame_ids=[f"{idx}_{i}"
                                          for i in range(len(imgs))])


class SyntheticSingleView:
    """Single-view items at the input size, in training as in evaluation:
    the synthetic items are not augmented (no crop), as in the JAX
    package."""

    def __init__(self, args):
        self.length = args.synthetic_length
        self.img_w, self.img_h = args.input_width, args.input_height

    def __len__(self):
        return self.length

    def get(self, idx: int, rng=None) -> Dict:
        rng = np.random.RandomState(idx)
        H, W = self.img_h, self.img_w
        depth = np.clip(2.5 + _smooth_noise(rng, H, W), 0.5, 9.5)
        tex = np.stack([_smooth_noise(rng, H, W) for _ in range(3)], -1)
        img = np.clip(0.5 + 0.25 * tex, 0, 1).astype(np.float32)
        return {"img": base.normalize_image(img).astype(np.float32),
                "depth": depth.astype(np.float32),
                "scene_name": "synthetic", "img_idx": str(idx)}
