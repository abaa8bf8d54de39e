"""D-Net evaluation entry point of the port.

    python -m magnet_tpu_torch.test_dnet test_scripts/dnet/<dataset>.txt [--device cpu]

Mirrors ``test_DNet.py``: build the model, load the checkpoint (a reference
torch ``.pt``; an empty ``--ckpt_path`` keeps seeded random weights),
evaluate every frame of the loader, and log the 12-metric table to
``exp/<name>/log/test_acc.txt``. ``--dataset_name`` scannet, 7scenes,
kitti_eigen or kitti_official reads the test split's tree under
``--dataset_path`` (``data/``); synthetic runs end to end without data on
disk. The model runs on ``--device`` (default
``cuda``) in ``--compute_dtype`` (default bfloat16).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from magnet_tpu_torch.core import config
from magnet_tpu_torch.data import TEST_MODES, make_singleview_loader
from magnet_tpu_torch.eval import harness, metrics
from magnet_tpu_torch.models import build


def make_forward(model: torch.nn.Module, dtype: torch.dtype,
                 device: torch.device) -> Callable[[np.ndarray], np.ndarray]:
    """img (1, H, W, 3) numpy -> (1, H, W, 2) = (mu, var) f32 numpy."""
    @torch.inference_mode()
    def forward(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(img)).to(device=device, dtype=dtype)
        return model(x).float().cpu().numpy()
    return forward


def prepare(args):
    """The model of the flags, loaded and cast, and its forward."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    model = build.build_dnet(args, device)
    print(f"loading checkpoint... {args.ckpt_path}")
    build.load_dnet_checkpoint(model, args.ckpt_path)
    print("loading checkpoint... / done")
    dtype = config.compute_dtype(args.compute_dtype)
    build.cast_for_inference(model, dtype)
    return model, make_forward(model, dtype, device)


def evaluate(args, forward) -> Dict[str, float]:
    """Every frame of the flags' loader through ``forward``; the 12-metric
    table is printed and appended to ``args.test_acc_txt``."""
    loader = make_singleview_loader(args, TEST_MODES[args.dataset_name])
    m = harness.evaluate_dnet(forward, loader, args)
    first_line = ("dataset: %s / d_min: %s / d_max: %s / ckpt_path: %s"
                  % (args.dataset_name, args.min_depth, args.max_depth,
                     args.ckpt_path))
    metrics.log_metrics(args.test_acc_txt, m, first_line)
    return m


def main(argv=None) -> Dict[str, float]:
    args = config.parse_args(config.build_test_dnet_parser(), argv)
    args = config.setup_exp_dirs(args)
    config.save_args(args, f"{args.exp_log_dir}/params.txt")
    _, forward = prepare(args)
    return evaluate(args, forward)


if __name__ == "__main__":
    main()
