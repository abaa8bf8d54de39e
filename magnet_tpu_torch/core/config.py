"""Command-line flags of the port's entry points.

The port's copy of the flags of ``magnet_tpu/core/config.py::
build_test_dnet_parser``, ``build_test_magnet_parser`` and
``build_train_fnet_parser``, in the same ``@file`` format
(whitespace-separated tokens, one or more per line), so the reference flag
files in ``test_scripts/`` and ``train_scripts/`` parse unchanged. Added:
``--device`` (default ``cuda``), and on the evaluation parsers the switches
of the kernels the JAX package runs only on request (environment variables
there): ``--mbconv_chain`` (``MAGNET_TPU_PALLAS_MB``), ``--dw_kernel``
(``MAGNET_TPU_PALLAS_DW``) and, for MaGNet, ``--stream_blocks``
(``MAGNET_TPU_PALLAS_RST``). The training parser takes the flags the
port reads and those the reference flag files set; argparse rejects the
JAX package's others, and ``check_train_flags`` raises on a value whose
feature the port does not have yet, rather than ignore it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def convert_arg_line_to_args(arg_line: str):
    """Split an @file line into individual tokens (whitespace tolerant)."""
    for arg in arg_line.split():
        if arg.strip():
            yield str(arg)


def build_test_dnet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(fromfile_prefix_chars="@")
    p.convert_arg_line_to_args = convert_arg_line_to_args
    p.add_argument("--exp_name", required=True, type=str)
    p.add_argument("--exp_dir", required=True, type=str)
    p.add_argument("--visible_gpus", default="0", type=str,
                   help="accepted for flag-file compatibility; unused")
    p.add_argument("--output_dim", required=True, type=int, help="{1, 2}")
    p.add_argument("--output_type", required=True, type=str, help="{R, G}")
    p.add_argument("--downsample_ratio", type=int, default=4)
    p.add_argument("--DNET_architecture", required=True, type=str,
                   help="DenseDepth_BN (the port's only D-Net)")
    p.add_argument("--DNET_fix_encoder_weights", type=str, default="None",
                   help="accepted for flag-file compatibility; unused")
    p.add_argument("--dataset_name", required=True, type=str)
    p.add_argument("--dataset_path", required=True, type=str)
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--crop_height", type=int, default=416)
    p.add_argument("--crop_width", type=int, default=544)
    p.add_argument("--min_depth", type=float, default=1e-3)
    p.add_argument("--max_depth", type=float, default=10)
    p.add_argument("--do_kb_crop", default=True, action="store_true")
    p.add_argument("--eigen_crop", default=False, action="store_true")
    p.add_argument("--garg_crop", default=False, action="store_true")
    p.add_argument("--ckpt_path", required=True, type=str,
                   help="reference torch .pt; empty keeps seeded weights")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   help="{bfloat16, float32}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_length", type=int, default=64,
                   help="items per split for the synthetic dataset")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions of "
                        "the kernels")
    add_trunk_switches(p)
    return p


def add_trunk_switches(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mbconv_chain", type=str, default="none",
                   help="'none', 'all' or a comma list of EfficientNet stage "
                        "indices whose stride-1 tail runs as one MBConv "
                        "chain (kernels.mbconv_chain)")
    p.add_argument("--dw_kernel", default=False, action="store_true",
                   help="stride-1 depthwise convs of the trunk through "
                        "kernels.dw_conv")


def parse_mbconv_chain(value: str):
    """``--mbconv_chain``: None, "all" or a tuple of stage indices."""
    if value in ("", "none"):
        return None
    if value == "all":
        return "all"
    try:
        return tuple(int(v) for v in value.split(","))
    except ValueError:
        raise ValueError(f"--mbconv_chain {value!r}: 'none', 'all' or a "
                         "comma list of stage indices") from None


def build_test_magnet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(fromfile_prefix_chars="@")
    p.convert_arg_line_to_args = convert_arg_line_to_args
    p.add_argument("--exp_name", required=True, type=str)
    p.add_argument("--exp_dir", required=True, type=str)
    p.add_argument("--visible_gpus", default="0", type=str,
                   help="accepted for flag-file compatibility; unused")
    p.add_argument("--output_dim", default=2, type=int, help="{1, 2}")
    p.add_argument("--output_type", default="G", type=str, help="{R, G}")
    p.add_argument("--downsample_ratio", type=int, default=4)
    p.add_argument("--DNET_architecture", type=str, default="DenseDepth_BN",
                   help="DenseDepth_BN (the port's only D-Net)")
    p.add_argument("--DNET_fix_encoder_weights", type=str, default="None",
                   help="accepted for flag-file compatibility; unused")
    p.add_argument("--DNET_ckpt", required=True, type=str,
                   help="reference torch .pt; empty keeps seeded weights")
    p.add_argument("--FNET_architecture", type=str, default="PSM-Net")
    p.add_argument("--FNET_feature_dim", type=int, default=64)
    p.add_argument("--FNET_ckpt", required=True, type=str,
                   help="reference torch .pt; empty keeps seeded weights")
    p.add_argument("--MAGNET_sampling_range", type=int, default=3)
    p.add_argument("--MAGNET_num_samples", type=int, default=5)
    p.add_argument("--MAGNET_mvs_weighting", type=str, default="CW5")
    p.add_argument("--MAGNET_num_train_iter", type=int, default=3)
    p.add_argument("--MAGNET_num_test_iter", type=int, default=3)
    p.add_argument("--MAGNET_window_radius", type=int, default=10)
    p.add_argument("--MAGNET_num_source_views", type=int, default=4)
    p.add_argument("--MAGNET_ckpt", default="", type=str,
                   help="reference torch .pt laid over the whole model")
    p.add_argument("--dataset_name", required=True, type=str)
    p.add_argument("--dataset_path", required=True, type=str)
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--dpv_height", type=int, default=120)
    p.add_argument("--dpv_width", type=int, default=160)
    p.add_argument("--min_depth", type=float, default=1e-3)
    p.add_argument("--max_depth", type=float, default=10)
    p.add_argument("--do_kb_crop", default=True, action="store_true")
    p.add_argument("--eigen_crop", default=False, action="store_true")
    p.add_argument("--garg_crop", default=False, action="store_true")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   help="{bfloat16, float32}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_length", type=int, default=64,
                   help="items per split for the synthetic dataset")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions of "
                        "the kernels")
    add_trunk_switches(p)
    p.add_argument("--stream_blocks", default=False, action="store_true",
                   help="each stride-1 F-Net BasicBlock as one "
                        "kernels.res_block launch")
    return p


def build_train_fnet_parser() -> argparse.ArgumentParser:
    """The flags of the reference train_FNet.py:236-295 that the port reads
    or that the reference flag files set, and ``--remat`` and
    ``--mesh_shape``, which raise unless off (``check_train_flags``)."""
    p = argparse.ArgumentParser(fromfile_prefix_chars="@")
    p.convert_arg_line_to_args = convert_arg_line_to_args
    p.add_argument("--exp_name", required=True, type=str)
    p.add_argument("--exp_dir", required=True, type=str)
    p.add_argument("--visible_gpus", default="0", type=str,
                   help="accepted for flag-file compatibility; unused")
    p.add_argument("--FNET_architecture", type=str, default="PSM-Net")
    p.add_argument("--FNET_feature_dim", type=int, default=64)
    p.add_argument("--MAGNET_window_radius", type=int, default=20,
                   help="accepted for flag-file compatibility; unused")
    p.add_argument("--MAGNET_num_source_views", type=int, default=4)
    p.add_argument("--loss_fn", default="l1", type=str)
    p.add_argument("--n_epochs", default=5, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--validate_every", default=5000, type=int)
    p.add_argument("--visualize_every", default=1000, type=int,
                   help="accepted; the port does not visualise yet")
    p.add_argument("--workers", default=4, type=int,
                   help="accepted; the port's loader runs in the caller")
    p.add_argument("--remat", default=False, action="store_true",
                   help="not in the port yet: raises")
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--lr", default=0.000357, type=float)
    p.add_argument("--grad_clip", default=1.0, type=float)
    p.add_argument("--div_factor", default=25, type=float)
    p.add_argument("--final_div_factor", default=10000, type=float)
    p.add_argument("--dataset_name", required=True, type=str)
    p.add_argument("--dataset_path", required=True, type=str)
    p.add_argument("--input_height", type=int, default=480)
    p.add_argument("--input_width", type=int, default=640)
    p.add_argument("--dpv_height", type=int, default=120)
    p.add_argument("--dpv_width", type=int, default=160)
    p.add_argument("--min_depth", type=float, default=1e-3)
    p.add_argument("--max_depth", type=float, default=10)
    p.add_argument("--eigen_crop", default=False, action="store_true")
    p.add_argument("--garg_crop", default=False, action="store_true")
    p.add_argument("--FNET_num_depth_bins", type=int, default=80,
                   help="number of fixed sweep planes for F-Net training")
    p.add_argument("--mesh_shape", type=str, default="auto",
                   help="'auto' or '1': the port trains on --device")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   help="{bfloat16, float32}")
    p.add_argument("--resume_ckpt", type=str, default="",
                   help="checkpoint directory to resume training from "
                        "(model, optimizer and schedule)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--synthetic_length", type=int, default=64,
                   help="items per split for the synthetic dataset")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions of "
                        "the kernels")
    return p


def check_train_flags(args: argparse.Namespace) -> None:
    """Raise on a training flag whose feature the port does not have."""
    unsupported = []
    if args.remat:
        unsupported.append("--remat")
    if args.mesh_shape not in ("auto", "1"):
        unsupported.append(f"--mesh_shape {args.mesh_shape} (one device)")
    if args.dataset_name != "synthetic":
        unsupported.append(f"--dataset_name {args.dataset_name} (the port "
                           "has 'synthetic')")
    if args.FNET_architecture != "PSM-Net":
        unsupported.append(f"--FNET_architecture {args.FNET_architecture}")
    if args.loss_fn != "l1":
        unsupported.append(f"--loss_fn {args.loss_fn}")
    if unsupported:
        raise ValueError("not ported yet: " + ", ".join(unsupported))


def parse_args(parser: argparse.ArgumentParser,
               argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse CLI args; a single positional argument is an @file."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and not argv[0].startswith("-"):
        argv = ["@" + argv[0]]
    return parser.parse_args(argv)


def setup_exp_dirs(args: argparse.Namespace,
                   kind: str = "test") -> argparse.Namespace:
    """exp/<name>/log, and for ``kind="train"`` exp/<name>/models and
    exp/<name>/vis too; the paths of the metric logs in the log
    directory."""
    args.exp_dir = os.path.join(args.exp_dir, args.exp_name)
    args.exp_log_dir = os.path.join(args.exp_dir, "log")
    dirs = [args.exp_log_dir]
    if kind == "train":
        args.exp_model_dir = os.path.join(args.exp_dir, "models")
        args.exp_vis_dir = os.path.join(args.exp_dir, "vis")
        dirs += [args.exp_model_dir, args.exp_vis_dir]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    args.eval_acc_txt = os.path.join(args.exp_log_dir, "eval_acc.txt")
    args.test_acc_txt = os.path.join(args.exp_log_dir, "test_acc.txt")
    return args


def save_args(args: argparse.Namespace, filename: str) -> None:
    """Dump one `key: value` per line."""
    with open(filename, "w") as f:
        for arg in vars(args):
            f.write("{}: {}\n".format(arg, getattr(args, arg)))


def compute_dtype(name: str):
    """The torch dtype named by ``--compute_dtype``."""
    import torch
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"unknown compute dtype {name!r}")
    return getattr(torch, name)
