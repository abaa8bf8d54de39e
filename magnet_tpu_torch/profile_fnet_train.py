"""Where an F-Net training step spends its time on the GPU.

``step_account`` runs the training step of ``train.steps`` as the entry
point runs it, with ``utils.profiling.StageTimes`` active: CUDA events around
the step's own span and each span inside it (the F-Net forward, the sweep
forward and softmax, soft-argmax and L1, the whole backward with its two
sweep parts, clip and AdamW), and the whole step by the host clock; the
F-Net backward is the backward less its sweep parts, the host gap the
host-clock step less the spans' sum. ``protocol_args`` are the flags of
``train_scripts/fnet/scannet.txt`` (480x640, batch 2, 4 source views, 80
sweep planes, cost volume 120x160, bf16 compute with f32 master weights) on
the synthetic dataset. ``chip_smoke.py`` phase 8 runs both at the protocol,
with ``profile_dnet.kernel_profile`` over two steps. Needs a CUDA device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from magnet_tpu_torch.core import config
from magnet_tpu_torch.data.synthetic import _small_pose
from magnet_tpu_torch.geometry import poses as poses_lib
from magnet_tpu_torch.geometry import rays as rays_lib
from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.models.magnet import sid_depth_centers
from magnet_tpu_torch.utils.profiling import StageTimes

FLAGS = "train_scripts/fnet/scannet.txt"
# the sweep at the protocol: image, cost volume, batch, source views, planes,
# feature channels
IMG_H, IMG_W, CV_H, CV_W = 480, 640, 120, 160
SWEEP_B, SWEEP_V, SWEEP_D, SWEEP_C = 2, 4, 80, 64
STEP = "F-Net step"
SWEEP_BACKWARD = ("sweep backward: grad_src (row-10 kernel)",
                  "sweep backward: grad_ref (plain re-gather)")


def step_account(step_fn, state, batch, iters: int = 3) -> dict:
    """ms per span of ``iters`` steps of ``step_fn`` on ``state`` (the first
    a warm-up, left out), and the step by the host clock."""
    host = []
    with StageTimes() as times:
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t))
    ms = times.ms(skip=1)
    # the spans directly inside the step, the backward apart (its sweep
    # parts run on autograd's thread, under no span of the step's)
    top = [n for n in ms if n != "backward"
           and times.host[n][0].parent == STEP]
    ms["F-Net backward (backward less the sweep backward)"] = (
        ms["backward"] - sum(ms[n] for n in SWEEP_BACKWARD))
    ms["step, host clock"] = sum(host[1:]) / (len(host) - 1)
    ms["host gap (host clock less the spans)"] = (
        ms["step, host clock"] - ms["backward"] - sum(ms[n] for n in top))
    return ms


def protocol_args(extra=()):
    """The flags of the protocol on the synthetic dataset."""
    return config.parse_args(config.build_train_fnet_parser(), [
        "@" + FLAGS, "--dataset_name", "synthetic", "--dataset_path",
        "none", "--exp_dir", "exp", "--device", "cuda"] + list(extra))


def sweep_case(roll: float = 0.0, invalid: bool = False,
               seed: int = 8) -> list:
    """Row-10 inputs at the F-Net training shape, on the CPU in f32: the
    protocol's SID sweep planes, the intrinsics and rays of a 480x640 frame
    at the cost volume's resolution, source poses as the synthetic dataset
    makes them (small random motion), each turned by ``roll`` radians about
    its optical axis, random features and cotangent. Returns the arguments
    of ``sweep_grad_src``: (d_center, ref_feat, gbar, R, t, is_valid, intM,
    rays2d)."""
    rng = np.random.RandomState(seed)
    fx = 0.9 * IMG_W
    K = np.array([[fx, 0, IMG_W / 2], [0, fx, IMG_H / 2], [0, 0, 1.0]])
    intM, rays2d = rays_lib.intrinsics_for_dpv(K, IMG_W, IMG_H, CV_W,
                                                CV_H)
    c, s = np.cos(roll), np.sin(roll)
    turn = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    ext = np.stack([[turn @ _small_pose(rng) for _ in range(SWEEP_V)]
                    for _ in range(SWEEP_B)])
    rel, valid = poses_lib.relative_poses(
        np.tile(np.eye(4), (SWEEP_B, 1, 1)), ext)
    R, t = poses_lib.split_rt(rel)
    if invalid:
        valid[0, 1] = 0.0
    arrays = [sid_depth_centers(1e-3, 10.0, SWEEP_D),
              rng.randn(SWEEP_B, CV_H, CV_W, SWEEP_C),
              rng.randn(SWEEP_B, CV_H, CV_W, SWEEP_D), R, t, valid,
              np.tile(intM, (SWEEP_B, 1, 1)),
              np.tile(rays2d, (SWEEP_B, 1, 1))]
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in arrays]


def sweep_grids(a: list) -> torch.Tensor:
    """The normalized sample positions (B*V, H*W, D, 2) of every (pixel,
    plane) in every view, as ``grid_sample`` takes them."""
    d, _, _, R, t, _, K, rays = a
    grids = []
    for b in range(R.shape[0]):
        for v in range(R.shape[1]):
            x, y, _ = cvk.project(K[b], R[b, v], t[b, v], rays[b],
                                  d.expand(CV_H * CV_W, -1), CV_H,
                                  CV_W)
            grids.append(torch.stack([(2 * x + 1) / CV_W - 1,
                                      (2 * y + 1) / CV_H - 1], -1))
    return torch.stack(grids)


def sweep_samples(a: list) -> tuple:
    """(in-image corners, samples) of the sweep for these inputs: the
    bilinear corners inside the map of every (pixel, plane) sample of every
    valid view, and the number of those samples."""
    grids = sweep_grids(a)
    valid = a[5].reshape(-1)
    corners = 0
    for i in range(grids.shape[0]):
        if valid[i] == 0:
            continue
        x = ((grids[i, ..., 0] + 1) * CV_W - 1) / 2
        y = ((grids[i, ..., 1] + 1) * CV_H - 1) / 2
        x0, y0 = torch.floor(x), torch.floor(y)
        for cy in (0, 1):
            for cx in (0, 1):
                corners += int((((x0 + cx) >= 0) & ((x0 + cx) < CV_W)
                                & ((y0 + cy) >= 0) & ((y0 + cy) < CV_H)).sum())
    return corners, CV_H * CV_W * SWEEP_D * int(valid.sum())
