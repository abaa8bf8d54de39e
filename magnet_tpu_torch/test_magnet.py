"""MaGNet evaluation entry point of the port.

    python -m magnet_tpu_torch.test_magnet test_scripts/magnet/<dataset>.txt [--device cpu]

Mirrors ``test_MaGNet.py``: build the whole pipeline, load the D-Net,
F-Net and MAGNET checkpoints (reference torch ``.pt`` files; empty paths
keep seeded random weights), evaluate every sample of the loader, and log
the 12-metric table to ``exp/<name>/log/test_acc.txt``. With
``--cache_features`` each distinct frame is encoded once
(``eval/streaming.py``, an LRU of ``--cache_max_frames`` encodings keyed by
the samples' ``view_ids``) and the cache's hits and misses are printed.
With ``--dataset_name synthetic`` it runs end to end without data on disk.
The model runs on ``--device`` (default ``cuda``) in ``--compute_dtype``
(default bfloat16); poses, intrinsics and rays stay f32.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from magnet_tpu_torch.core import config
from magnet_tpu_torch.data.synthetic import make_multiview_loader
from magnet_tpu_torch.eval import harness, metrics, streaming
from magnet_tpu_torch.models import build

GEOMETRY_KEYS = ("R", "t", "is_valid", "intM", "rays2d")


def batch_to_device(batch: Dict[str, np.ndarray], dtype: torch.dtype,
                    device: torch.device):
    """The model's arguments from a collated batch: images in ``dtype``,
    geometry in f32."""
    imgs = [torch.from_numpy(np.asarray(batch[k])).to(device=device,
                                                       dtype=dtype)
            for k in ("ref_img", "src_imgs")]
    geo = [torch.from_numpy(np.asarray(batch[k], np.float32)).to(device)
           for k in GEOMETRY_KEYS]
    return imgs + geo


def make_forward(model: torch.nn.Module, dtype: torch.dtype,
                 device: torch.device, n_iters: int
                 ) -> Callable[[Dict], np.ndarray]:
    """batch (numpy) -> the last iteration's (1, H, W, 2) = (mu, sigma),
    f32 numpy."""
    @torch.inference_mode()
    def forward(batch: Dict) -> np.ndarray:
        preds = model(*batch_to_device(batch, dtype, device),
                      n_iters=n_iters)
        return preds[-1].float().cpu().numpy()
    return forward


def prepare(args):
    """The model of the flags, loaded and cast, and its forward: the
    streaming forward with ``--cache_features`` (its cache as the forward's
    ``cache``), else the monolithic one."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    model = build.build_magnet(args, device)
    print(f"loading checkpoints... D={args.DNET_ckpt} F={args.FNET_ckpt} "
          f"M={args.MAGNET_ckpt}")
    build.load_magnet_checkpoints(model, args)
    print("loading checkpoints... / done")
    dtype = config.compute_dtype(args.compute_dtype)
    build.cast_for_inference(model, dtype)
    if args.cache_features:
        forward, cache = streaming.make_streaming_forward(
            model, dtype, device, args.MAGNET_num_test_iter,
            max_frames=args.cache_max_frames)
        forward.cache = cache
        return model, forward
    return model, make_forward(model, dtype, device,
                               args.MAGNET_num_test_iter)


def evaluate(args, forward) -> Dict[str, float]:
    """Every sample of the flags' loader through ``forward``; the 12-metric
    table is printed and appended to ``args.test_acc_txt``."""
    loader = make_multiview_loader(args)
    m = harness.evaluate_magnet(forward, loader, args)
    first_line = ("dataset: %s / d_min: %s / d_max: %s / ckpt_path: %s"
                  % (args.dataset_name, args.min_depth, args.max_depth,
                     args.MAGNET_ckpt))
    metrics.log_metrics(args.test_acc_txt, m, first_line)
    cache = getattr(forward, "cache", None)
    if cache is not None:
        print(f"feature cache: {cache.hits} hits / {cache.misses} misses "
              f"({100 * cache.hit_rate:.1f}% hit rate)")
    return m


def main(argv=None) -> Dict[str, float]:
    args = config.parse_args(config.build_test_magnet_parser(), argv)
    args = config.setup_exp_dirs(args)
    config.save_args(args, f"{args.exp_log_dir}/params.txt")
    _, forward = prepare(args)
    return evaluate(args, forward)


if __name__ == "__main__":
    main()
