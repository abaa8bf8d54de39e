"""7-Scenes datasets (test-only zero-shot transfer; dataloader_7scenes.py).

The port's copy of ``magnet_tpu/data/sevenscenes.py``. Fixed intrinsics
fx = fy = 585, cx = 320, cy = 240; frame files
``seq-%02d/frame-%06d.{color.png,depth.png,pose.txt}``; depth sentinel
65535 -> 0, then / 1000; the window as for ScanNet.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from magnet_tpu_torch.data import base
from magnet_tpu_torch.data.scannet import (_make_loader, _pack_multiview,
                                           load_split)
from magnet_tpu_torch.geometry import rays as rays_lib

_K_7SCENES = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1.0]])


class SevenScenesMultiView:
    def __init__(self, args, mode: str):
        # one public split (long_test); mode kept for the dispatch
        self.entries = load_split("sevenscenes_long_test.txt")
        self.args = args
        self.root = args.dataset_path
        self.img_w, self.img_h = args.input_width, args.input_height
        self.dpv_w, self.dpv_h = args.dpv_width, args.dpv_height
        self.n_views = args.MAGNET_num_source_views
        self.offsets, self.interval = base.window_indices(
            self.n_views, args.MAGNET_window_radius)
        self.center = self.n_views // 2
        # The reference takes the input resolution as the raw one here
        # (dataloader_7scenes.py:85): the images are 640x480.
        self.intM, self.rays2d = rays_lib.intrinsics_for_dpv(
            _K_7SCENES, self.img_w, self.img_h, self.dpv_w, self.dpv_h)

    def __len__(self):
        return len(self.entries)

    def get(self, idx: int, rng) -> Dict:
        scene, seq_id, img_idx = (self.entries[idx][0],
                                  int(self.entries[idx][1]),
                                  int(self.entries[idx][2]))
        seq_dir = os.path.join(self.root, scene, "seq-%02d" % seq_id)

        def exists(i):
            return os.path.exists(
                os.path.join(seq_dir, "frame-%06d.color.png" % i))

        idx_list = [base.fallback_index(img_idx, off, self.interval, exists)
                    for off in self.offsets]

        imgs, extMs, depth = [], [], None
        for i, ci in enumerate(idx_list):
            img = base.load_image(
                os.path.join(seq_dir, "frame-%06d.color.png" % ci),
                size=(self.img_w, self.img_h))
            imgs.append(base.normalize_image(img))
            extMs.append(base.read_matrix_txt(
                os.path.join(seq_dir, "frame-%06d.pose.txt" % ci),
                invert=True))
            if i == self.center:
                depth = base.load_depth_png(
                    os.path.join(seq_dir, "frame-%06d.depth.png" % ci),
                    scale=1000.0, size=(self.img_w, self.img_h),
                    sentinel=65535)

        return _pack_multiview(imgs, extMs, depth, self.center, self.intM,
                               self.rays2d, f"{scene}_seq-{seq_id:02d}",
                               str(img_idx),
                               frame_ids=[str(ci) for ci in idx_list])


class SevenScenesSingleView:
    """dataloader_7scenes_D.py: single frames, test only."""

    def __init__(self, args, mode: str):
        self.entries = load_split("sevenscenes_long_test.txt")
        self.root = args.dataset_path
        self.img_w, self.img_h = args.input_width, args.input_height

    def __len__(self):
        return len(self.entries)

    def get(self, idx: int, rng) -> Dict:
        scene, seq_id, img_idx = (self.entries[idx][0],
                                  int(self.entries[idx][1]),
                                  int(self.entries[idx][2]))
        seq_dir = os.path.join(self.root, scene, "seq-%02d" % seq_id)
        img = base.load_image(
            os.path.join(seq_dir, "frame-%06d.color.png" % img_idx),
            size=(self.img_w, self.img_h))
        depth = base.load_depth_png(
            os.path.join(seq_dir, "frame-%06d.depth.png" % img_idx),
            scale=1000.0, size=(self.img_w, self.img_h), sentinel=65535)
        return {"img": base.normalize_image(img).astype(np.float32),
                "depth": depth.astype(np.float32),
                "scene_name": f"{scene}_seq-{seq_id:02d}",
                "img_idx": str(img_idx)}


def SevenScenesMultiViewLoader(args, mode):
    return _make_loader(SevenScenesMultiView(args, mode), args, mode)


def SevenScenesSingleViewLoader(args, mode):
    return _make_loader(SevenScenesSingleView(args, mode), args, mode)
