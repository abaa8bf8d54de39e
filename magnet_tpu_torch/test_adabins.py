"""AdaBins evaluation entry point of the port.

    python -m magnet_tpu_torch.test_adabins <flag file> [--device cpu]

Mirrors the published AdaBins ``evaluate.py`` on the port's single-view
loaders (``data.make_singleview_loader``), as ``test_dnet.py`` mirrors
``test_DNet.py``: build the model (``models.build.build_adabins``; an empty
``--ADABINS_ckpt`` keeps seeded random weights), and for every image of the
test split average the depth with that of the flipped image (each clipped
to [``--min_depth``, ``--max_depth``] first), resize it to the ground
truth's size (bilinear, align corners), clip it again and log the
12-metric table of ``eval/metrics.py`` (no variance: NLL 0) to
``exp/<name>/log/test_acc.txt``. ``--dataset_name kitti_eigen`` with
``--garg_crop`` is the published KITTI evaluation; synthetic runs end to
end without data on disk. The model runs on ``--device`` (default
``cuda``) in ``--compute_dtype`` (default bfloat16).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from magnet_tpu_torch.core import config
from magnet_tpu_torch.data import TEST_MODES, make_singleview_loader
from magnet_tpu_torch.eval import harness, metrics
from magnet_tpu_torch.models import build
from magnet_tpu_torch.ops.resample import resize_bilinear_align_corners


def make_forward(model: torch.nn.Module, dtype: torch.dtype,
                 device: torch.device, min_depth: float, max_depth: float
                 ) -> Callable[[np.ndarray, Tuple[int, int]], np.ndarray]:
    """(img (1, H, W, 3) numpy, (h, w)) -> the flip-averaged depth (h, w)
    f32 numpy."""
    @torch.inference_mode()
    def forward(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
        x = torch.from_numpy(np.asarray(img)).to(device=device, dtype=dtype)
        pred = model(x)[1].clamp(min_depth, max_depth)
        flipped = model(torch.flip(x, dims=[2]))[1]
        pred_lr = torch.flip(flipped, dims=[2]).clamp(min_depth, max_depth)
        final = resize_bilinear_align_corners((0.5 * (pred + pred_lr))[
            ..., None], *size)
        return final[0, ..., 0].cpu().numpy()
    return forward


def prepare(args):
    """The model of the flags, loaded and cast, and its forward."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    print(f"loading checkpoint... {args.ADABINS_ckpt}")
    model = build.build_adabins(args, device)
    print("loading checkpoint... / done")
    dtype = config.compute_dtype(args.compute_dtype)
    build.cast_for_inference(model, dtype)
    return model, make_forward(model, dtype, device, args.min_depth,
                               args.max_depth)


def evaluate(args, forward) -> Dict[str, float]:
    """Every image of the flags' loader through ``forward``; the 12-metric
    table is printed and appended to ``args.test_acc_txt``."""
    loader = make_singleview_loader(args, TEST_MODES[args.dataset_name])
    m = harness.evaluate_adabins(forward, loader, args)
    first_line = ("dataset: %s / d_min: %s / d_max: %s / ckpt_path: %s"
                  % (args.dataset_name, args.min_depth, args.max_depth,
                     args.ADABINS_ckpt))
    metrics.log_metrics(args.test_acc_txt, m, first_line)
    return m


def main(argv=None) -> Dict[str, float]:
    args = config.parse_args(config.build_test_adabins_parser(), argv)
    args = config.setup_exp_dirs(args)
    config.save_args(args, f"{args.exp_log_dir}/params.txt")
    _, forward = prepare(args)
    return evaluate(args, forward)


if __name__ == "__main__":
    main()
