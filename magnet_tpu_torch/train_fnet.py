"""F-Net training entry point of the port (stage 2 of 3).

    python -m magnet_tpu_torch.train_fnet train_scripts/fnet/<dataset>.txt [--device cpu]

Mirrors ``train_FNet.py``: the PSM-Net matching features are trained through
the fixed SID plane sweep (``--FNET_num_depth_bins`` planes) with an L1 loss
on the soft-argmax depth, AdamW with one-cycle schedules. It logs a loss
line every ``--log_every`` samples, dumps images every ``--visualize_every``
samples (``utils/visualize.py``: the first sample's soft-argmax depth),
validates into
``exp/<name>/log/eval_acc.txt`` and writes a checkpoint (model, optimizer,
schedule, step) under ``exp/<name>/models/`` at each validation and at the
end; ``--resume_ckpt`` continues from one. The step runs on ``--device``
(default ``cuda``; no card is an error) in ``--compute_dtype`` (default
bfloat16) with f32 master weights; the validation forward runs the f32
weights in eval mode, through the F-Net's inference kernels. ``--remat``
recomputes the F-Net's blocks in the backward. ``--dataset_name`` scannet,
kitti_eigen or kitti_official reads the tree under ``--dataset_path``
(``data/``, with the colour augmentation); synthetic runs without data on
disk. The visualisation is not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from magnet_tpu_torch.core import config, distributed, mesh
from magnet_tpu_torch.data import (TRAIN_MODES, VAL_MODES,
                                   make_multiview_loader)
from magnet_tpu_torch.eval import harness
from magnet_tpu_torch.models.build import build_magnet_f
from magnet_tpu_torch.models.magnet import sid_depth_centers
from magnet_tpu_torch.train import checkpoint, loop, losses, optim, steps
from magnet_tpu_torch.utils import visualize as vis

GEOMETRY_KEYS = ("R", "t", "is_valid", "intM", "rays2d")


def batch_to_device(batch: Dict[str, np.ndarray], dpv_hw,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's inputs from a collated batch, f32 on ``device``; the
    ground truth nearest-downsampled to the cost volume's resolution on the
    host (train_FNet.py:98)."""
    h, w = dpv_hw
    d = batch["depth"]
    ry, rx = d.shape[1] // h, d.shape[2] // w
    out = {k: batch[k] for k in ("ref_img", "src_imgs") + GEOMETRY_KEYS}
    out["depth_dpv"] = d[:, ::ry, ::rx][:, :h, :w]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in out.items()}


def make_val_forward(model: torch.nn.Module, d_center: torch.Tensor,
                     device: torch.device):
    """batch (numpy) -> (1, h, w) soft-argmax depth, f32 numpy: the f32
    master weights in eval mode; the model is back in train mode after."""
    @torch.inference_mode()
    def forward(batch) -> np.ndarray:
        model.eval()
        try:
            args = [torch.from_numpy(np.asarray(batch[k], np.float32)
                                     ).to(device)
                    for k in ("ref_img", "src_imgs") + GEOMETRY_KEYS]
            cv = model(*args, d_center)
            return losses.soft_argmax_depth(cv, d_center).cpu().numpy()
        finally:
            model.train()
    return forward


def train(args) -> Dict:
    """The training run of parsed flags (``train/loop.py::run``): the final
    state, the loss and time of every step, the last validation's metrics
    and the last checkpoint's directory. Under the process group that the
    environment names (``core/distributed.py``; joined before anything is
    built, left at the end) each rank trains on its share of every batch
    (``core/mesh.py``) and rank 0 validates and saves."""
    with distributed.session(args.device):
        return _train(args)


def _train(args) -> Dict:
    config.check_train_flags(args)
    mesh.world_from_args(args)
    device = loop.device_of(args)
    train_loader = make_multiview_loader(args,
                                         TRAIN_MODES[args.dataset_name])
    val_loader = make_multiview_loader(args, VAL_MODES[args.dataset_name])
    d_center = torch.from_numpy(sid_depth_centers(
        args.min_depth, args.max_depth, args.FNET_num_depth_bins)).to(device)

    model = build_magnet_f(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Number of model parameters: {n_params}")
    total_steps = len(train_loader) * args.n_epochs
    opt = optim.make_fnet_optimizer(
        model.parameters(), lr=args.lr, total_steps=total_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        div_factor=args.div_factor, final_div_factor=args.final_div_factor)
    state = steps.TrainState(model, opt, seed=args.seed)
    if args.resume_ckpt:
        state = checkpoint.restore(args.resume_ckpt, state)
        print(f"resumed from step {state.step}")
    mesh.replicate(model)
    step_fn = steps.make_fnet_train_step(
        d_center, args.max_depth, args.min_depth,
        compute_dtype=config.compute_dtype(args.compute_dtype))
    val_forward = make_val_forward(model, d_center, device)

    def visualize(raw, batch, total_iter):
        """The soft-argmax depth of the batch's first sample
        (train_FNet.py:101-108,138)."""
        pred = val_forward({k: raw[k][:1]
                            for k in ("ref_img", "src_imgs") + GEOMETRY_KEYS})
        vis.visualize_fnet(args, raw["ref_img"][:1], raw["depth"][:1], pred,
                           total_iter)

    return loop.run(
        args, state, step_fn, train_loader,
        lambda raw: batch_to_device(raw, (args.dpv_height, args.dpv_width),
                                    device),
        lambda: harness.evaluate_fnet(val_forward, val_loader, args,
                                      progress=False), visualize)


def main(argv=None) -> Dict:
    args = config.parse_args(config.build_train_fnet_parser(), argv)
    args = config.setup_exp_dirs(args, kind="train")
    config.save_args(args, f"{args.exp_log_dir}/params.txt")
    return train(args)


if __name__ == "__main__":
    main()
