"""ScanNet datasets.

The port's copy of ``magnet_tpu/data/scannet.py``.

Multi-view (dataloader_scannet.py): the train / rob_test / long_test splits
of ``data_split/``; a local window of V source views with the
existence-checked fallback; colour JPEGs bilinearly resized to
(input_W, input_H); the reference frame's depth PNG / 1000; pose text files
inverted cam2world -> world2cam; each scene's raw W/H from
``scannet_raw_WH.json`` rescales the intrinsics to the cost volume's
resolution and builds the unit rays; one colour augmentation drawn for all
frames of a training sample.

Single-view (dataloader_scannet_D.py): a frame's image and depth, with the
training augmentations rotate +-2.5 deg, flip, random crop (crop_H x crop_W)
and colour.

Relative poses and their validity are computed here on the host, so the
model sees dense arrays only.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from magnet_tpu_torch.core.distributed import rank_world
from magnet_tpu_torch.data import base
from magnet_tpu_torch.geometry import poses as poses_lib
from magnet_tpu_torch.geometry import rays as rays_lib

_SPLITS = {"train": ("scannet_train.txt", "scans"),
           "rob_test": ("scannet_rob_test.txt", "scans_test"),
           "long_test": ("scannet_long_test.txt", "scans_test")}


def _split_dir() -> str:
    """The repository's ``data_split/``."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "data_split")


def load_split(fname: str):
    """The whitespace-split lines of a split file of ``data_split/``."""
    with open(os.path.join(_split_dir(), fname)) as f:
        return [ln.split() for ln in f.read().strip().splitlines() if ln]


class ScanNetMultiView:
    def __init__(self, args, mode: str):
        split, self.scans = _SPLITS[mode]
        self.entries = load_split(split)
        self.mode = mode
        self.args = args
        self.root = args.dataset_path
        self.img_w, self.img_h = args.input_width, args.input_height
        self.dpv_w, self.dpv_h = args.dpv_width, args.dpv_height
        self.n_views = args.MAGNET_num_source_views
        self.offsets, self.interval = base.window_indices(
            self.n_views, args.MAGNET_window_radius)
        self.center = self.n_views // 2
        with open(os.path.join(_split_dir(), "scannet_raw_WH.json")) as f:
            self.raw_wh = json.load(f)
        self.color_aug = ("train" in mode and
                          getattr(args, "data_augmentation_color", True))

    def __len__(self):
        return len(self.entries)

    def get(self, idx: int, rng: np.random.RandomState) -> Dict:
        scene, img_idx = self.entries[idx][0], int(self.entries[idx][1])
        scene_dir = os.path.join(self.root, self.scans, scene)

        def exists(i):
            return os.path.exists(
                os.path.join(scene_dir, "color", f"{i}.jpg"))

        idx_list = [base.fallback_index(img_idx, off, self.interval, exists)
                    for off in self.offsets]

        raw_w, raw_h = self.raw_wh[scene]
        K_raw = base.read_matrix_txt(
            os.path.join(scene_dir, "intrinsic", "intrinsic_color.txt"))
        intM, rays2d = rays_lib.intrinsics_for_dpv(
            K_raw, raw_w, raw_h, self.dpv_w, self.dpv_h)

        aug = base.draw_color_aug(rng, (0.75, 1.25)) if self.color_aug \
            else None

        imgs, extMs = [], []
        depth = None
        for i, ci in enumerate(idx_list):
            img = base.load_image(
                os.path.join(scene_dir, "color", f"{ci}.jpg"),
                size=(self.img_w, self.img_h))
            if aug is not None:
                img = base.color_augment(img, *aug)
            imgs.append(base.normalize_image(img))
            extMs.append(base.read_matrix_txt(
                os.path.join(scene_dir, "pose", f"{ci}.txt"), invert=True))
            if i == self.center:
                depth = base.load_depth_png(
                    os.path.join(scene_dir, "depth", f"{ci}.png"),
                    scale=1000.0, size=(self.img_w, self.img_h))

        return _pack_multiview(imgs, extMs, depth, self.center, intM,
                               rays2d, scene, str(img_idx),
                               frame_ids=[str(ci) for ci in idx_list])


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


class ScanNetSingleView:
    def __init__(self, args, mode: str):
        split, self.scans = _SPLITS[mode]
        self.entries = load_split(split)
        self.mode = mode
        self.args = args
        self.root = args.dataset_path
        self.img_w, self.img_h = args.input_width, args.input_height
        self.crop_h = getattr(args, "crop_height", 416)
        self.crop_w = getattr(args, "crop_width", 544)
        self.rotate_deg = 2.5

    def __len__(self):
        return len(self.entries)

    def get(self, idx: int, rng: np.random.RandomState) -> Dict:
        scene, img_idx = self.entries[idx][0], int(self.entries[idx][1])
        scene_dir = os.path.join(self.root, self.scans, scene)
        img = base.load_image(
            os.path.join(scene_dir, "color", f"{img_idx}.jpg"),
            size=(self.img_w, self.img_h))
        depth = base.load_depth_png(
            os.path.join(scene_dir, "depth", f"{img_idx}.png"),
            scale=1000.0, size=(self.img_w, self.img_h))
        if self.mode == "train":
            img, depth = _train_augs(rng, self.args, img, depth,
                                     self.rotate_deg, self.crop_h,
                                     self.crop_w,
                                     brightness_range=(0.75, 1.25))
        return {"img": base.normalize_image(img).astype(np.float32),
                "depth": depth.astype(np.float32),
                "scene_name": scene, "img_idx": str(img_idx)}


def _train_augs(rng, args, img, depth, rotate_deg, crop_h, crop_w,
                brightness_range):
    """Single-view training augmentations in the reference's order: rotate,
    flip, crop, colour (dataloader_scannet_D.py:84-110), each switched by
    its ``--data_augmentation_*`` flag. The depth is metric already, and a
    nearest rotation commutes with the scaling."""
    if getattr(args, "data_augmentation_rotate", True):
        angle = (rng.rand() - 0.5) * 2 * rotate_deg
        img, depth = base.rotate_pair(img, depth, angle)
    if getattr(args, "data_augmentation_flip", True) and rng.rand() > 0.5:
        img = img[:, ::-1].copy()
        depth = depth[:, ::-1].copy()
    if getattr(args, "data_augmentation_crop", True):
        img, depth = base.random_crop_pair(rng, img, depth, crop_h, crop_w)
    if getattr(args, "data_augmentation_color", True):
        aug = base.draw_color_aug(rng, brightness_range)
        if aug is not None:
            img = base.color_augment(img, *aug)
    return img, depth


def _make_loader(dataset, args, mode: str) -> base.Loader:
    """The loader of a dataset for ``mode``: a mode containing "train"
    shuffles at ``--batch_size`` (the global batch) on ``--workers``
    threads, this rank's share of each batch under a process group
    (``core/distributed.rank_world``); any other is the evaluation loader,
    batch 1 on one thread (run by rank 0). One host: (0, 1)."""
    train = "train" in mode
    rank, world = rank_world() if train else (0, 1)
    return base.Loader(
        dataset,
        batch_size=args.batch_size if train else 1,
        train=train, seed=getattr(args, "seed", 0),
        num_workers=getattr(args, "workers", 4) if train else 1,
        host_index=0, host_count=1, shard_index=rank, shard_count=world)


def ScanNetMultiViewLoader(args, mode):
    return _make_loader(ScanNetMultiView(args, mode), args, mode)


def ScanNetSingleViewLoader(args, mode):
    return _make_loader(ScanNetSingleView(args, mode), args, mode)
