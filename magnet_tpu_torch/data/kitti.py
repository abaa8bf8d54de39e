"""KITTI datasets.

The port's copy of ``magnet_tpu/data/kitti.py``.

Multi-view (dataloader_kitti.py): the kb-crop to 352x1216, intrinsics
shifted by the crop's margins and rescaled to the cost volume's resolution,
ground-truth depth PNG / 256. The reference's ``pykitti`` calibration and
OXTS -> pose maths are implemented here (Mercator projection,
roll/pitch/yaw rotation, poses relative to the first frame of the window).

Single-view (dataloader_kitti_D.py): the kb-crop; training augmentations
rotate +-1.0 deg, flip, random crop 352x704, colour. The reference's
``official_train`` split never augments: its condition compares the split
line's token (dataloader_kitti_D.py:89, ``self.mode == 'eigen_train' or
mode == 'official_train'`` where ``mode`` is 'train'/'val'); kept here, as
the JAX package keeps it.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List

import numpy as np

from magnet_tpu_torch.data import base
from magnet_tpu_torch.data.scannet import (_make_loader, _pack_multiview,
                                           _train_augs, load_split)

KB_H, KB_W = 352, 1216
_ER = 6378137.0          # earth radius (m)

_SPLIT_FILES = {"eigen_train": "kitti_eigen_train.txt",
                "eigen_test": "kitti_eigen_test.txt",
                "eigen_val": "kitti_eigen_val.txt",
                "official_train": "kitti_official_train.txt",
                "official_test": "kitti_official_test.txt"}


def _read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """``key: v0 v1 ...`` lines as float arrays; lines without numbers are
    skipped."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                out[k.strip()] = np.array([float(x) for x in v.split()])
            except ValueError:
                pass
    return out


def _rt_to_mat(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = R.reshape(3, 3)
    m[:3, 3] = T
    return m


@lru_cache(maxsize=32)
def load_calib(date_dir: str):
    """(K_cam2 (3, 3), T_cam2_imu (4, 4)) of a capture date."""
    imu2velo = _read_calib_file(
        os.path.join(date_dir, "calib_imu_to_velo.txt"))
    velo2cam = _read_calib_file(
        os.path.join(date_dir, "calib_velo_to_cam.txt"))
    cam2cam = _read_calib_file(
        os.path.join(date_dir, "calib_cam_to_cam.txt"))

    T_velo_imu = _rt_to_mat(imu2velo["R"], imu2velo["T"])
    T_cam0_velo = _rt_to_mat(velo2cam["R"], velo2cam["T"])

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect_20 = cam2cam["P_rect_02"].reshape(3, 4)

    T2 = np.eye(4)
    T2[0, 3] = P_rect_20[0, 3] / P_rect_20[0, 0]
    T_cam2_velo = T2 @ R_rect @ T_cam0_velo
    T_cam2_imu = T_cam2_velo @ T_velo_imu
    K_cam2 = P_rect_20[:3, :3]
    return K_cam2, T_cam2_imu


def _rotation_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def oxts_poses(oxts_rows: List[np.ndarray]) -> List[np.ndarray]:
    """T_w_imu per frame from raw OXTS packets (lat lon alt roll pitch yaw
    ...). The Mercator scale comes from the first frame, the positions are
    relative to it (pykitti.raw on a subset of frames)."""
    scale = np.cos(oxts_rows[0][0] * np.pi / 180.0)
    poses, origin = [], None
    for row in oxts_rows:
        lat, lon, alt, roll, pitch, yaw = row[:6]
        tx = scale * lon * np.pi * _ER / 180.0
        ty = scale * _ER * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
        t = np.array([tx, ty, alt])
        if origin is None:
            origin = t
        T = np.eye(4)
        T[:3, :3] = _rotation_rpy(roll, pitch, yaw)
        T[:3, 3] = t - origin
        poses.append(T)
    return poses


def _kb_margins(raw_h: int, raw_w: int):
    """(top, left) of the kb-crop (the bottom-centre 352x1216 window)."""
    return int(raw_h - KB_H), int((raw_w - KB_W) / 2)


class KittiMultiView:
    def __init__(self, args, mode: str):
        self.entries = load_split(_SPLIT_FILES[mode])
        self.mode = mode
        self.args = args
        self.root = args.dataset_path
        self.img_w, self.img_h = args.input_width, args.input_height
        self.dpv_w, self.dpv_h = args.dpv_width, args.dpv_height
        self.n_views = args.MAGNET_num_source_views
        self.offsets, self.interval = base.window_indices(
            self.n_views, args.MAGNET_window_radius)
        self.center = self.n_views // 2
        self.color_aug = ("train" in mode and
                          getattr(args, "data_augmentation_color", True))

    def __len__(self):
        return len(self.entries)

    def _intrinsics(self, K_cam2, raw_w, raw_h):
        """Crop-shift and rescale to the cost volume's resolution
        (dataloader_kitti.py:99-127)."""
        top, left = _kb_margins(raw_h, raw_w)
        intM = np.zeros((3, 3))
        intM[2, 2] = 1.0
        intM[0, 0] = K_cam2[0, 0] * (self.dpv_w / float(self.img_w))
        intM[1, 1] = K_cam2[1, 1] * (self.dpv_h / float(self.img_h))
        intM[0, 2] = (K_cam2[0, 2] - left) * (self.dpv_w / float(self.img_w))
        intM[1, 2] = (K_cam2[1, 2] - top) * (self.dpv_h / float(self.img_h))

        grid = np.ones((self.dpv_h, self.dpv_w, 3))
        grid[:, :, 0] = np.arange(self.dpv_w)[None] + 0.5
        grid[:, :, 1] = np.arange(self.dpv_h)[:, None] + 0.5
        rays = grid.copy()
        rays[:, :, 0] = (grid[:, :, 0] * (self.img_w / float(self.dpv_w))
                         - K_cam2[0, 2] + left) / K_cam2[0, 0]
        rays[:, :, 1] = (grid[:, :, 1] * (self.img_h / float(self.dpv_h))
                         - K_cam2[1, 2] + top) / K_cam2[1, 1]
        rays2d = rays.transpose(2, 0, 1).reshape(3, -1)
        return intM.astype(np.float32), rays2d.astype(np.float32)

    def get(self, idx: int, rng) -> Dict:
        date, drive, split_tok, img_idx = self.entries[idx][:4]
        img_idx = int(img_idx)
        scene = f"{date}_drive_{drive}_sync"
        date_dir = os.path.join(self.root, "rawdata", date)
        drive_dir = os.path.join(date_dir, scene)
        idx_list = [img_idx + off for off in self.offsets]

        K_cam2, T_cam2_imu = load_calib(date_dir)

        aug = base.draw_color_aug(rng, (0.9, 1.1)) if self.color_aug \
            else None

        oxts_rows = []
        for ci in idx_list:
            p = os.path.join(drive_dir, "oxts", "data", "%010d.txt" % ci)
            if os.path.exists(p):
                oxts_rows.append(np.loadtxt(p))
            else:
                oxts_rows.append(np.full(30, np.nan))
        T_w_imu = oxts_poses(oxts_rows)

        imgs, extMs, depth = [], [], None
        raw_wh = None
        for i, ci in enumerate(idx_list):
            img_path = os.path.join(drive_dir, "image_02", "data",
                                    "%010d.png" % ci)
            img = base.load_image(img_path)
            raw_h, raw_w = img.shape[:2]
            raw_wh = (raw_w, raw_h)
            top, left = _kb_margins(raw_h, raw_w)
            img = img[top:top + KB_H, left:left + KB_W]
            if aug is not None:
                img = base.color_augment(img, *aug)
            imgs.append(base.normalize_image(img))
            # extM = T_cam2_imu @ inv(T_w_imu) (dataloader_kitti.py:186-188)
            extMs.append(T_cam2_imu @ np.linalg.inv(T_w_imu[i]))
            if i == self.center:
                dpath = os.path.join(self.root, split_tok, scene,
                                     "proj_depth", "groundtruth",
                                     "image_02", "%010d.png" % ci)
                d = base.load_depth_png(dpath, scale=256.0)
                depth = d[top:top + KB_H, left:left + KB_W]

        intM, rays2d = self._intrinsics(K_cam2, *raw_wh)
        return _pack_multiview(imgs, extMs, depth, self.center, intM,
                               rays2d, scene, str(img_idx),
                               frame_ids=[str(ci) for ci in idx_list])


class KittiSingleView:
    def __init__(self, args, mode: str):
        self.entries = load_split(_SPLIT_FILES[mode])
        self.mode = mode
        self.args = args
        self.root = args.dataset_path
        self.crop_h = getattr(args, "crop_height", 352)
        self.crop_w = getattr(args, "crop_width", 704)

    def __len__(self):
        return len(self.entries)

    def get(self, idx: int, rng) -> Dict:
        date, drive, split_tok, img_idx = self.entries[idx][:4]
        img_idx = int(img_idx)
        scene = f"{date}_drive_{drive}_sync"
        img_path = os.path.join(self.root, "rawdata", date, scene,
                                "image_02", "data", "%010d.png" % img_idx)
        dpath = os.path.join(self.root, split_tok, scene, "proj_depth",
                             "groundtruth", "image_02",
                             "%010d.png" % img_idx)
        img = base.load_image(img_path)
        depth = base.load_depth_png(dpath, scale=256.0)

        if getattr(self.args, "do_kb_crop", True):
            top, left = _kb_margins(*img.shape[:2])
            img = img[top:top + KB_H, left:left + KB_W]
            depth = depth[top:top + KB_H, left:left + KB_W]

        # the reference's quirk (module note): only eigen_train augments
        if self.mode == "eigen_train":
            img, depth = _train_augs(rng, self.args, img, depth,
                                     rotate_deg=1.0, crop_h=self.crop_h,
                                     crop_w=self.crop_w,
                                     brightness_range=(0.9, 1.1))
        return {"img": base.normalize_image(img).astype(np.float32),
                "depth": depth.astype(np.float32),
                "scene_name": scene, "img_idx": str(img_idx)}


def KittiMultiViewLoader(args, mode):
    return _make_loader(KittiMultiView(args, mode), args, mode)


def KittiSingleViewLoader(args, mode):
    return _make_loader(KittiSingleView(args, mode), args, mode)
