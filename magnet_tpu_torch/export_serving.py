"""Write the serving programs of a MaGNet: the monolithic forward and the
streaming encode/fuse pair (``serve/export.py``).

    python -m magnet_tpu_torch.export_serving test_scripts/magnet/scannet.txt \
        --out_dir exported_serving [--device cpu]

The port's counterpart of ``scripts/export_serving.py``. The model of the
``test_magnet`` flags (``--DNET_ckpt``/``--FNET_ckpt``/``--MAGNET_ckpt``
loaded where given) is traced at ``--input_height`` x ``--input_width``
with ``--MAGNET_num_source_views`` views and ``--MAGNET_num_test_iter``
iterations in ``--compute_dtype``, on ``--device`` (default the card: the
programs then hold the port's kernels as ``torch.ops.magnet_tpu_torch``
operators; on the CPU, their plain versions). The programs take the f32
state dict as their first argument; run one with
``magnet_tpu_torch.serve.load_exported(open(path, "rb").read())(state,
...)``.
"""

from __future__ import annotations

import argparse
import os

import torch

from magnet_tpu_torch import serve
from magnet_tpu_torch.core import config
from magnet_tpu_torch.models import build


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out_dir", default="exported_serving")
    extra, rest = ap.parse_known_args(argv)
    args = config.parse_args(config.build_test_magnet_parser(), rest)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    model = build.build_magnet(args, args.device)
    build.load_magnet_checkpoints(model, args)
    dtype = config.compute_dtype(args.compute_dtype)
    h, w = args.input_height, args.input_width
    v, n_iters = args.MAGNET_num_source_views, args.MAGNET_num_test_iter
    os.makedirs(extra.out_dir, exist_ok=True)
    paths = {}
    for name, make in (
            ("monolithic", lambda: serve.export_monolithic(
                model, h, w, v, n_iters=n_iters, compute_dtype=dtype)),
            ("encode", lambda: serve.export_encode(
                model, h, w, compute_dtype=dtype)),
            ("fuse", lambda: serve.export_fuse(
                model, h, w, v, n_iters=n_iters, compute_dtype=dtype))):
        blob = make()
        path = os.path.join(extra.out_dir, f"magnet_{name}.pt2")
        with open(path, "wb") as f:
            f.write(blob)
        print(f"{path}: {len(blob) / 1e6:.2f} MB")
        paths[name] = path
    return paths


if __name__ == "__main__":
    main()
