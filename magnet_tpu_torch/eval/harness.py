"""Evaluation harness: the reference's per-image metric protocol.

The port's copy of ``magnet_tpu/eval/harness.py::evaluate_dnet``,
``evaluate_fnet`` and ``evaluate_magnet``, and ``evaluate_adabins``, the
published AdaBins ``evaluate.py``'s protocol. Per test image (batch 1):
forward, copy to the host, valid-pixel mask (+ optional garg/eigen crop),
clamp/scrub the prediction, 12 metrics into a streaming average.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from magnet_tpu_torch.eval import metrics as M


def _eval_one(gt, mu, var, args):
    valid = M.eval_mask(gt, args.min_depth, args.max_depth,
                        args.dataset_name, garg_crop=args.garg_crop,
                        eigen_crop=args.eigen_crop)
    if not valid.any():
        return None
    pred = M.clamp_pred(mu, args.min_depth, args.max_depth)
    if var is not None:
        # scrub non-finite variances so one bad pixel cannot NaN the table
        var = np.nan_to_num(var, nan=1e-6, posinf=1e6, neginf=1e-6)[valid]
    return M.compute_depth_errors(gt[valid], pred[valid], var)


def evaluate_dnet(forward: Callable, loader, args,
                  progress: bool = True) -> Dict[str, float]:
    """forward(img (1, H, W, 3) numpy) -> (1, H, W, 2) = (mu, var), numpy."""
    avg = M.RunningAverageDict()
    for i, batch in enumerate(loader):
        gt = np.asarray(batch["depth"])[0]
        out = np.asarray(forward(batch["img"]))
        m = _eval_one(gt, out[0, :, :, 0], out[0, :, :, 1], args)
        if m is not None:
            avg.update(m)
        if progress and i % 200 == 0:
            print(f"  eval {i}/{len(loader)}", flush=True)
    return avg.get_value()


def evaluate_adabins(forward: Callable, loader, args,
                     progress: bool = True) -> Dict[str, float]:
    """forward(img (1, H, W, 3) numpy, (h, w)) -> the (h, w) depth at the
    ground truth's size, numpy. No variance: the table's NLL is 0."""
    avg = M.RunningAverageDict()
    for i, batch in enumerate(loader):
        gt = np.asarray(batch["depth"])[0]
        m = _eval_one(gt, np.asarray(forward(batch["img"], gt.shape)), None,
                      args)
        if m is not None:
            avg.update(m)
        if progress and i % 200 == 0:
            print(f"  eval {i}/{len(loader)}", flush=True)
    return avg.get_value()


def evaluate_fnet(forward: Callable, loader, args,
                  progress: bool = True) -> Dict[str, float]:
    """F-Net validation during training (train_FNet.py:148-186):
    forward(batch) -> (1, h, w) soft-argmax depth at the cost volume's
    resolution, numpy, nearest-upsampled to the ground truth's; ground truth
    above the maximum zeroed; no variance, so the table has no NLL row."""
    avg = M.RunningAverageDict()
    for i, batch in enumerate(loader):
        gt = np.asarray(batch["depth"])[0]
        gt = np.where(gt > args.max_depth, 0.0, gt)
        pred = np.asarray(forward(batch))[0]
        H, W = gt.shape
        iy = (np.arange(H) * pred.shape[0] // H).astype(np.int64)
        ix = (np.arange(W) * pred.shape[1] // W).astype(np.int64)
        m = _eval_one(gt, pred[iy][:, ix], None, args)
        if m is not None:
            avg.update(m)
        if progress and i % 200 == 0:
            print(f"  eval {i}/{len(loader)}", flush=True)
    return avg.get_value()


def evaluate_magnet(forward: Callable, loader, args,
                    progress: bool = True) -> Dict[str, float]:
    """forward(batch of numpy arrays) -> the final (1, H, W, 2) =
    (mu, sigma), numpy."""
    avg = M.RunningAverageDict()
    for i, batch in enumerate(loader):
        gt = np.asarray(batch["depth"])[0]
        # ground truth above the maximum is zeroed before masking
        gt = np.where(gt > args.max_depth, 0.0, gt)
        out = np.asarray(forward(batch))
        m = _eval_one(gt, out[0, :, :, 0], np.square(out[0, :, :, 1]), args)
        if m is not None:
            avg.update(m)
        if progress and i % 200 == 0:
            print(f"  eval {i}/{len(loader)}", flush=True)
    return avg.get_value()
