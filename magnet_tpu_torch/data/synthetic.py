"""Synthetic datasets: procedurally generated images, smooth depth maps and
(multi-view) small random camera motion with consistent intrinsics and ray
arrays, so the evaluation and training paths run end to end without data
on disk. The port's copy of ``magnet_tpu/data/synthetic.py``: the same seed
gives the same frames in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from magnet_tpu_torch.data import base
from magnet_tpu_torch.geometry import poses as poses_lib
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


def _pack_multiview(imgs, extMs, depth, center, intM, rays2d, scene,
                    img_idx, frame_ids=None) -> Dict:
    """Split reference and sources; relative poses and their validity.
    ``frame_ids``, one token a frame of ``imgs``, become ``view_ids`` =
    ["scene/ref", "scene/src0", ...], the keys of the streaming cache
    (``eval/streaming.py``): the same frame must get the same id."""
    ref_ext = np.asarray(extMs[center])[None]
    src_ext = np.asarray([extMs[i] for i in range(len(extMs))
                          if i != center])[None]
    rel, valid = poses_lib.relative_poses(ref_ext, src_ext)
    R, t = poses_lib.split_rt(rel)
    src_imgs = np.stack([imgs[i] for i in range(len(imgs)) if i != center])
    out = {
        "ref_img": imgs[center].astype(np.float32),
        "src_imgs": src_imgs.astype(np.float32),
        "depth": depth.astype(np.float32),
        "R": R[0], "t": t[0], "is_valid": valid[0],
        "intM": intM.astype(np.float32),
        "rays2d": rays2d.astype(np.float32),
        "scene_name": scene, "img_idx": img_idx,
    }
    if frame_ids is not None:
        out["view_ids"] = [f"{scene}/{frame_ids[center]}"] + [
            f"{scene}/{frame_ids[i]}" for i in range(len(frame_ids))
            if i != center]
    return out


class SyntheticMultiView:
    def __init__(self, args):
        self.length = args.synthetic_length
        self.img_w, self.img_h = args.input_width, args.input_height
        self.dpv_w, self.dpv_h = args.dpv_width, args.dpv_height
        self.n_views = args.MAGNET_num_source_views
        self.center = self.n_views // 2

    def __len__(self):
        return self.length

    def get(self, idx: int) -> Dict:
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
    """Single-view items at the input size, or at ``size`` (H, W): the
    D-Net's training crop."""

    def __init__(self, args, size=None):
        self.length = args.synthetic_length
        self.img_h, self.img_w = size or (args.input_height, args.input_width)

    def __len__(self):
        return self.length

    def get(self, idx: int) -> Dict:
        rng = np.random.RandomState(idx)
        H, W = self.img_h, self.img_w
        depth = np.clip(2.5 + _smooth_noise(rng, H, W), 0.5, 9.5)
        tex = np.stack([_smooth_noise(rng, H, W) for _ in range(3)], -1)
        img = np.clip(0.5 + 0.25 * tex, 0, 1).astype(np.float32)
        return {"img": base.normalize_image(img).astype(np.float32),
                "depth": depth.astype(np.float32),
                "scene_name": "synthetic", "img_idx": str(idx)}


def make_multiview_loader(args, mode: str = "test") -> base.Loader:
    """Dataset dispatch for the multi-view paths: a mode containing "train"
    gives the shuffled training loader at ``--batch_size``, any other mode
    the evaluation loader at batch 1. The on-disk datasets are not ported
    yet."""
    if args.dataset_name == "synthetic":
        train = "train" in mode
        return base.Loader(SyntheticMultiView(args),
                           batch_size=args.batch_size if train else 1,
                           train=train, seed=getattr(args, "seed", 0))
    raise ValueError(f"dataset {args.dataset_name!r} is not ported; "
                     "the port has 'synthetic'")


def make_singleview_loader(args, mode: str = "test") -> base.Loader:
    """Dataset dispatch for the D-Net: a mode containing "train" gives the
    shuffled training loader at ``--batch_size``, its items drawn at
    ``--crop_height`` x ``--crop_width`` (the size of the reference's random
    crop), any other mode the evaluation loader at batch 1 and the input
    size. The on-disk datasets are not ported yet."""
    if args.dataset_name == "synthetic":
        if "train" in mode:
            return base.Loader(
                SyntheticSingleView(args, (args.crop_height, args.crop_width)),
                batch_size=args.batch_size, train=True,
                seed=getattr(args, "seed", 0))
        return base.Loader(SyntheticSingleView(args))
    raise ValueError(f"dataset {args.dataset_name!r} is not ported; "
                     "the port has 'synthetic'")
