"""The port's training dumps (magnet_tpu_torch/utils/visualize.py) against
the JAX package's (magnet_tpu/utils/visualize.py, matplotlib's ``imsave``),
on the CPU.

The port writes with PIL and numpy alone (the card's machine has no
matplotlib): its ``jet`` and ``Reds`` tables equal matplotlib's bytes, and
each of the three dumps writes files byte-equal to the JAX package's at the
same seeded inputs (values below the range, above it, infinite and NaN
among them), for an indoor and an outdoor dataset. The training entry
points write them under ``exp/<name>/vis`` every ``--visualize_every``
samples.
"""

import argparse
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from magnet_tpu.utils import visualize as jvis
from magnet_tpu_torch import train_dnet, train_fnet, train_magnet
from magnet_tpu_torch.utils import visualize as vis

from test_torch_kernels import torch_threads  # noqa: F401

H, W = 16, 24
REPO = Path(__file__).resolve().parents[1]


def test_tables_equal_matplotlib():
    import matplotlib
    for name, table in (("jet", vis.JET), ("Reds", vis.REDS)):
        cmap = matplotlib.colormaps[name]
        rgba = cmap(np.arange(256), bytes=True)
        np.testing.assert_array_equal(table, rgba[:, :3])
        assert (rgba[:, 3] == 255).all()


def _case(seed: int = 0):
    """A normalised image, ground truth with holes and far values, and a
    (mu, var) map with values under, over and outside the colour range."""
    rng = np.random.RandomState(seed)
    img = rng.randn(1, H, W, 3).astype(np.float32)
    gt = rng.uniform(0, 70, (1, H, W)).astype(np.float32)
    gt[0, 0, :5] = 0.0
    pred = np.stack([gt[0] + rng.randn(H, W).astype(np.float32) * 3,
                     rng.uniform(0, 4, (H, W)).astype(np.float32)], -1)[None]
    pred[0, 1, 1, 0] = -1.0
    pred[0, 1, 2, 0] = np.inf
    pred[0, 2, 2, 1] = np.nan
    return img, gt, pred


def _dump(module, fn, dataset, tmp):
    img, gt, pred = _case()
    args = argparse.Namespace(dataset_name=dataset, min_depth=1e-3,
                              max_depth=10.0 if dataset == "scannet"
                              else 80.0, exp_vis_dir=str(tmp))
    tmp.mkdir()
    if fn == "visualize_fnet":
        getattr(module, fn)(args, img, gt, pred[:, ::4, ::4, 0], 3)
    elif fn == "visualize_magnet":
        getattr(module, fn)(args, img, gt, [pred, pred[..., ::-1] * 0.5], 7)
    else:
        getattr(module, fn)(args, img, gt, pred, 42)
    return {p.name: p.read_bytes() for p in sorted(tmp.iterdir())}


@pytest.mark.parametrize("dataset", ["scannet", "kitti_eigen"])
@pytest.mark.parametrize("fn", ["visualize_dnet", "visualize_fnet",
                                "visualize_magnet"])
def test_dumps_equal_the_jax_package_byte_for_byte(tmp_path, fn, dataset):
    want = _dump(jvis, fn, dataset, tmp_path / "jax")
    got = _dump(vis, fn, dataset, tmp_path / "port")
    assert len(want) == {"visualize_dnet": 5, "visualize_fnet": 4,
                         "visualize_magnet": 8}[fn]
    assert got.keys() == want.keys()
    for name, data in want.items():
        assert got[name] == data, name


def test_dumps_take_tensors(tmp_path):
    img, gt, pred = _case()
    args = argparse.Namespace(dataset_name="scannet", min_depth=1e-3,
                              max_depth=10.0, exp_vis_dir=str(tmp_path))
    vis.visualize_dnet(args, torch.from_numpy(img), torch.from_numpy(gt),
                       torch.from_numpy(pred).to(torch.bfloat16), 1)
    with Image.open(tmp_path / "00000001_pred_stdev.jpg") as im:
        assert im.size == (W, H) and im.mode == "RGB"


def test_writes_without_matplotlib(tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "magnet_tpu_torch.utils.visualize")
    fresh = importlib.import_module("magnet_tpu_torch.utils.visualize")
    assert fresh is not vis
    img, gt, pred = _case()
    args = argparse.Namespace(dataset_name="7scenes", min_depth=1e-3,
                              max_depth=10.0, exp_vis_dir=str(tmp_path))
    fresh.visualize_magnet(args, img, gt, [pred], 5)
    assert len(os.listdir(tmp_path)) == 2 + 3


SMALL = ["--dataset_name", "synthetic", "--dataset_path", "none",
         "--device", "cpu", "--input_height", "32", "--input_width", "32",
         "--batch_size", "1", "--synthetic_length", "2", "--n_epochs", "1",
         "--validate_every", "1000000", "--visualize_every", "2",
         "--workers", "1", "--compute_dtype", "float32"]
ENTRIES = {
    "dnet": (train_dnet, "dnet/scannet.txt", [], [
        "img", "gt_dmap", "pred_dmap", "pred_emap", "pred_stdev"]),
    "fnet": (train_fnet, "fnet/scannet.txt", [
        "--dpv_height", "8", "--dpv_width", "8", "--FNET_feature_dim", "16",
        "--FNET_num_depth_bins", "8", "--MAGNET_num_source_views", "2"], [
        "img", "gt_dmap", "pred_dmap", "pred_emap"]),
    "magnet": (train_magnet, "magnet/scannet.txt", [
        "--dpv_height", "8", "--dpv_width", "8",
        "--MAGNET_num_source_views", "2", "--MAGNET_num_train_iter", "2",
        "--MAGNET_num_test_iter", "1", "--DNET_ckpt", "", "--FNET_ckpt",
        ""], ["img", "gt_dmap"] + [
        f"pred_{k}_iter{i:02d}" for i in range(2)
        for k in ("dmap", "emap", "stdev")]),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_point_writes_its_dumps(tmp_path, entry):
    """Two steps at batch 1 and ``--visualize_every 2``: rank 0 dumps the
    eval forward of the batch's first sample after step 2 only (the JAX
    cadence, total_iter % visualize_every < batch_size); MaGNet one set of
    maps for each of its --MAGNET_num_train_iter iterations."""
    module, flags, extra, names = ENTRIES[entry]
    module.main(["@" + str(REPO / "train_scripts" / flags), "--exp_name", "v",
                 "--exp_dir", str(tmp_path)] + SMALL + extra)
    got = sorted(p.name for p in (tmp_path / "v" / "vis").iterdir())
    assert got == sorted(f"00000002_{n}.jpg" for n in names)
    for name in got:
        with Image.open(tmp_path / "v" / "vis" / name) as im:
            assert im.size == (32, 32) and im.format == "JPEG"
