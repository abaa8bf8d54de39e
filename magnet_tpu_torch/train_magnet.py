"""MaGNet training entry point of the port (stage 3 of 3).

    python -m magnet_tpu_torch.train_magnet train_scripts/magnet/<dataset>.txt [--device cpu]

Mirrors ``train_MaGNet.py``: the D-Net and F-Net come from their stage
checkpoints (``--DNET_ckpt``, ``--FNET_ckpt``: reference ``.pt`` files or
the port's ``train_dnet`` / ``train_fnet`` checkpoints; empty keeps seeded
weights) and stay frozen in eval mode, running their inference kernels;
G-Net and the mask head train (plain convs with autograd) on the
gamma-weighted Gaussian NLL (``--loss_fn gaussian``, ``--loss_gamma``) of
all ``--MAGNET_num_train_iter`` upsampled iterations, AdamW with one-cycle
schedules. The cost volume runs row 4's kernel on the batch, the
upsampling's backward its own kernel. It logs a loss line every
``--log_every`` steps, dumps images every ``--visualize_every`` samples
(``utils/visualize.py``: each of the ``--MAGNET_num_train_iter``
iterations' maps of the first sample, in eval mode), validates (``eval/harness.evaluate_magnet``, the f32
weights in eval mode at ``--MAGNET_num_test_iter`` iterations) into
``exp/<name>/log/eval_acc.txt`` and writes a checkpoint under
``exp/<name>/models/`` at each validation and at the end; ``--resume_ckpt``
continues from one. The step runs on ``--device`` (default ``cuda``; no card
is an error) in ``--compute_dtype`` (default bfloat16) with f32 master
weights. ``--dataset_name`` scannet, kitti_eigen or kitti_official reads
the tree under ``--dataset_path`` (``data/``); synthetic runs without data
on disk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from magnet_tpu_torch.core import config, distributed, mesh
from magnet_tpu_torch.data import (TRAIN_MODES, VAL_MODES,
                                   make_multiview_loader)
from magnet_tpu_torch.eval import harness
from magnet_tpu_torch.models.build import build_magnet_train
from magnet_tpu_torch.train import checkpoint, loop, optim, steps
from magnet_tpu_torch.utils import visualize as vis


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's inputs (``steps.MAGNET_INPUTS`` and the depth), f32 on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32)
                                ).to(device)
            for k in steps.MAGNET_INPUTS + ("depth",)}


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
    config.check_train_flags(args, loss_fn="gaussian")
    mesh.world_from_args(args)
    device = loop.device_of(args)
    train_loader = make_multiview_loader(args,
                                         TRAIN_MODES[args.dataset_name])
    val_loader = make_multiview_loader(args, VAL_MODES[args.dataset_name])

    print(f"loading DNET... {args.DNET_ckpt}")
    print(f"loading FNET... {args.FNET_ckpt}")
    model = build_magnet_train(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Number of model parameters: {n_params}")
    opt = optim.make_magnet_optimizer(
        model, lr=args.lr, total_steps=len(train_loader) * args.n_epochs,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        div_factor=args.div_factor, final_div_factor=args.final_div_factor)
    state = steps.TrainState(model, opt, seed=args.seed)
    if args.resume_ckpt:
        state = checkpoint.restore(args.resume_ckpt, state)
        print(f"resumed from step {state.step}")
    mesh.replicate(model)
    step_fn = steps.make_magnet_train_step(
        args.loss_gamma, args.max_depth, args.min_depth,
        args.MAGNET_num_train_iter,
        compute_dtype=config.compute_dtype(args.compute_dtype))
    eval_fn = steps.make_magnet_eval_fn(model, args.MAGNET_num_test_iter)

    # every one of the training iterations' maps (train_MaGNet.py:91-93)
    vis_fn = steps.make_magnet_eval_fn(model, args.MAGNET_num_train_iter,
                                       return_all=True)

    def val_forward(raw) -> np.ndarray:
        return eval_fn(batch_to_device(raw, device)).float().cpu().numpy()

    def visualize(raw, batch, total_iter):
        """The eval forward of the batch's first sample
        (train_MaGNet.py:121-126)."""
        preds = vis_fn({k: batch[k][:1] for k in steps.MAGNET_INPUTS})
        vis.visualize_magnet(args, raw["ref_img"][:1], raw["depth"][:1],
                             preds, total_iter)

    return loop.run(
        args, state, step_fn, train_loader,
        lambda raw: batch_to_device(raw, device),
        lambda: harness.evaluate_magnet(val_forward, val_loader, args,
                                        progress=False), visualize)


def main(argv=None) -> Dict:
    args = config.parse_args(config.build_train_magnet_parser(), argv)
    args = config.setup_exp_dirs(args, kind="train")
    config.save_args(args, f"{args.exp_log_dir}/params.txt")
    return train(args)


if __name__ == "__main__":
    main()
