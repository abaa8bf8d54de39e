"""D-Net training entry point of the port (stage 1 of 3).

    python -m magnet_tpu_torch.train_dnet train_scripts/dnet/<dataset>.txt [--device cpu]

Mirrors ``train_DNet.py``: the D-Net (EfficientNet-B5 encoder, BatchNorm
decoder, convex upsampling) is trained with the Gaussian NLL on its
(mu, var) at ``--crop_height`` x ``--crop_width``, AdamW with one-cycle
schedules, the encoder at a tenth of the learning rate (``--same_lr``: the
same). ``--encoder_ckpt`` starts the encoder from a ``tf_efficientnet_b5_ap``
ImageNet state dict; ``--DNET_fix_encoder_weights AdaBins_fix`` loads the
AdaBins encoder (``core/config.py::ADABINS_ENCODER``) and freezes it
(``compat/encoder.py``). It logs a loss line every ``--log_every`` steps,
validates at the input size into ``exp/<name>/log/eval_acc.txt`` and writes
a checkpoint (model, optimizer, schedule, step, generator) under
``exp/<name>/models/`` at each validation and at the end, which
``--DNET_ckpt`` of ``test_dnet``, ``test_magnet`` and ``train_magnet``
loads; ``--resume_ckpt`` continues from one. The step runs on ``--device``
(default ``cuda``; no card is an error) in ``--compute_dtype`` (default
bfloat16) with f32 master weights, train-mode BatchNorm and drop path (the
masks from the training state's generator), plain convs with autograd and
the convex upsampling's backward kernel; ``--remat`` recomputes the trunk's
blocks in the backward. The validation forward runs the f32 weights in
eval mode, through the D-Net's inference kernels. With ``--dataset_name
synthetic`` it runs without data on disk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from magnet_tpu_torch.compat import encoder
from magnet_tpu_torch.core import config
from magnet_tpu_torch.data.synthetic import make_singleview_loader
from magnet_tpu_torch.eval import harness
from magnet_tpu_torch.models.build import build_dnet_train
from magnet_tpu_torch.train import checkpoint, loop, optim, steps


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's inputs, img and depth, f32 on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32)
                                ).to(device) for k in ("img", "depth")}


def train(args) -> Dict:
    """The training run of parsed flags (``train/loop.py::run``): the final
    state, the loss and time of every step, the last validation's metrics
    and the last checkpoint's directory."""
    config.check_train_flags(args, loss_fn="gaussian")
    fix = args.DNET_fix_encoder_weights
    if fix not in ("None", "AdaBins_fix"):
        raise ValueError(f"--DNET_fix_encoder_weights {fix}: None or "
                         "AdaBins_fix")
    device = loop.device_of(args)
    train_loader = make_singleview_loader(args, "train")
    val_loader = make_singleview_loader(args, "test")

    model = build_dnet_train(args, device)
    if fix == "AdaBins_fix":
        encoder.load_adabins_encoder(model, config.ADABINS_ENCODER)
    elif args.encoder_ckpt:
        encoder.load_hub_encoder(model, args.encoder_ckpt)
        print(f"encoder initialized from {args.encoder_ckpt}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Number of model parameters: {n_params}")
    opt = optim.make_dnet_optimizer(
        model, lr=args.lr, total_steps=len(train_loader) * args.n_epochs,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        same_lr=args.same_lr, div_factor=args.div_factor,
        final_div_factor=args.final_div_factor,
        freeze_encoder=fix == "AdaBins_fix")
    state = steps.TrainState(model, opt, seed=args.seed)
    if args.resume_ckpt:
        state = checkpoint.restore(args.resume_ckpt, state)
        print(f"resumed from step {state.step}")
    step_fn = steps.make_dnet_train_step(
        args.max_depth, args.min_depth,
        compute_dtype=config.compute_dtype(args.compute_dtype))
    eval_fn = steps.make_dnet_eval_fn(model)

    def val_forward(img) -> np.ndarray:
        x = torch.from_numpy(np.asarray(img, np.float32)).to(device)
        return eval_fn(x).float().cpu().numpy()

    return loop.run(
        args, state, step_fn, train_loader,
        lambda raw: batch_to_device(raw, device),
        lambda: harness.evaluate_dnet(val_forward, val_loader, args,
                                      progress=False))


def main(argv=None) -> Dict:
    args = config.parse_args(config.build_train_dnet_parser(), argv)
    args = config.setup_exp_dirs(args, kind="train")
    config.save_args(args, f"{args.exp_log_dir}/params.txt")
    return train(args)


if __name__ == "__main__":
    main()
