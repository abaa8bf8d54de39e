"""F-Net training entry point of the port (stage 2 of 3).

    python -m magnet_tpu_torch.train_fnet train_scripts/fnet/<dataset>.txt [--device cpu]

Mirrors ``train_FNet.py``: the PSM-Net matching features are trained through
the fixed SID plane sweep (``--FNET_num_depth_bins`` planes) with an L1 loss
on the soft-argmax depth, AdamW with one-cycle schedules. It logs a loss
line every ``--log_every`` samples, validates into
``exp/<name>/log/eval_acc.txt`` and writes a checkpoint (model, optimizer,
schedule, step) under ``exp/<name>/models/`` at each validation and at the
end; ``--resume_ckpt`` continues from one. The step runs on ``--device``
(default ``cuda``; no card is an error) in ``--compute_dtype`` (default
bfloat16) with f32 master weights; the validation forward runs the f32
weights in eval mode, through the F-Net's inference kernels. With
``--dataset_name synthetic`` it runs without data on disk; the on-disk
datasets and the visualisation are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from magnet_tpu_torch.core import config
from magnet_tpu_torch.data.synthetic import make_multiview_loader
from magnet_tpu_torch.eval import harness, metrics
from magnet_tpu_torch.models.build import build_magnet_f
from magnet_tpu_torch.models.magnet import sid_depth_centers
from magnet_tpu_torch.train import checkpoint, losses, optim, steps
from magnet_tpu_torch.utils.profiling import StepTimer

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
    """The training run of parsed flags. Returns the final state, the loss
    and time of every step (host clock with the loss read, and CUDA events
    around the step on a card), the last validation's metrics and the last
    checkpoint's directory."""
    config.check_train_flags(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    train_loader = make_multiview_loader(args, "train")
    val_loader = make_multiview_loader(args, "test")
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
    step_fn = steps.make_fnet_train_step(
        d_center, args.max_depth, args.min_depth,
        compute_dtype=config.compute_dtype(args.compute_dtype))
    val_forward = make_val_forward(model, d_center, device)

    def run_validation():
        return harness.evaluate_fnet(val_forward, val_loader, args,
                                     progress=False)

    on_card = device.type == "cuda"
    out = dict(losses=[], step_ms=[], step_event_ms=[])
    total_iter, t0, timer, mts, ckpt = 0, time.time(), StepTimer(), None, ""
    for epoch in range(args.n_epochs):
        for raw in train_loader:
            batch = batch_to_device(raw, (args.dpv_height, args.dpv_width),
                                    device)
            t_step = time.perf_counter()
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            state, m = step_fn(state, batch)
            if on_card:
                ev[1].record()
            loss = float(m["loss"])                # waits for the step
            out["step_ms"].append(1e3 * (time.perf_counter() - t_step))
            if on_card:
                out["step_event_ms"].append(ev[0].elapsed_time(ev[1]))
            out["losses"].append(loss)
            sps = timer.tick()
            total_iter += args.batch_size
            if total_iter % (args.log_every * args.batch_size) < \
                    args.batch_size:
                print(f"epoch {epoch + 1}/{args.n_epochs} iter {total_iter} "
                      f"loss {loss:.5f} ({time.time() - t0:.1f}s, "
                      f"{sps:.2f} steps/s)", flush=True)
            if total_iter % args.validate_every < args.batch_size:
                mts = run_validation()
                metrics.log_metrics(args.eval_acc_txt, mts,
                                    f"total_iter: {total_iter}")
                ckpt = checkpoint.save(args.exp_model_dir, state, total_iter)
    mts = run_validation()
    metrics.log_metrics(args.eval_acc_txt, mts, f"total_iter: {total_iter}")
    ckpt = checkpoint.save(args.exp_model_dir, state, total_iter)
    return dict(out, state=state, metrics=mts, ckpt=ckpt)


def main(argv=None) -> Dict:
    args = config.parse_args(config.build_train_fnet_parser(), argv)
    args = config.setup_exp_dirs(args, kind="train")
    config.save_args(args, f"{args.exp_log_dir}/params.txt")
    return train(args)


if __name__ == "__main__":
    main()
