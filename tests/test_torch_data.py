"""The port's input pipeline (magnet_tpu_torch/data) against the JAX
package's, on the CPU.

Every reader and augmentation helper of ``data/base.py`` against its JAX
twin on seeded arrays and files, equal bit for bit; then small scene trees
written here in the datasets' layouts (as tests/test_datasets_ondisk.py
writes them, the split files replaced as the JAX tests replace them):
ScanNet multi-view and single-view, 7-Scenes, KITTI eigen_test multi-view,
eigen_train and official_train single-view, each through both packages'
loaders with the same seed and epoch, training augmentations on, at one and
at four workers: the batches are equal bit for bit. Also the OXTS poses on
tests/test_oxts_golden.py's packets, the four entry points on a ScanNet tree
with the GroupNorm D-Net, the split file the repository lacks, and the
synthetic single-view training batches (drawn at the input size, as the JAX
package draws them).
"""

import argparse

import numpy as np
import pytest
import torch
from PIL import Image

from magnet_tpu import data as jdata
from magnet_tpu.data import base as jbase
from magnet_tpu.data import kitti as jkitti
from magnet_tpu.data import scannet as jscannet
from magnet_tpu.data import sevenscenes as jsevenscenes
from magnet_tpu_torch import data as tdata
from magnet_tpu_torch import test_dnet, test_magnet, train_dnet, train_magnet
from magnet_tpu_torch.core import config
from magnet_tpu_torch.data import base, kitti, scannet, sevenscenes
from magnet_tpu_torch.nn.densedepth import UpSampleGN

from test_oxts_golden import _GOLDEN, _PACKETS
from test_torch_kernels import torch_threads  # noqa: F401

SCENE = "scene0707_00"          # in data_split/scannet_raw_WH.json
KITTI_DATE, KITTI_DRIVE = "2011_09_26", "0002"
KITTI_RAW_W, KITTI_RAW_H = 1242, 375


def _rgb(path, w, h, seed):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
        path)


def _depth16(path, w, h, seed, lo=500, hi=5000, sentinel=False):
    d = np.random.RandomState(seed).randint(lo, hi, (h, w)).astype(np.uint16)
    if sentinel:
        d[::7, ::5] = 65535
    Image.fromarray(d).save(path)
    return d


def _pose(path, t):
    m = np.eye(4)
    m[:3, :3] = np.array([[np.cos(t), -np.sin(t), 0],
                          [np.sin(t), np.cos(t), 0], [0, 0, 1]])
    m[:3, 3] = [0.1 * t, 0.02, -0.05 * t]
    np.savetxt(path, m)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """ScanNet (scans and scans_test), 7-Scenes and KITTI trees, small
    frames (KITTI at its raw size, which the kb-crop needs); the
    depth values each ground-truth PNG holds."""
    root = tmp_path_factory.mktemp("data")
    written = {}
    for scans in ("scans", "scans_test"):
        scene = root / "scannet" / scans / SCENE
        for sub in ("color", "depth", "pose", "intrinsic"):
            (scene / sub).mkdir(parents=True)
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 1170.2, 1170.2, 647.8, 483.8
        np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", K)
        for i in range(6):
            _rgb(scene / "color" / f"{i}.jpg", 80, 60, seed=i)
            written[scans, i] = _depth16(scene / "depth" / f"{i}.png", 64, 48,
                                         seed=i)
            _pose(scene / "pose" / f"{i}.txt", 0.01 * i)
    seq = root / "7scenes" / "chess" / "seq-03"
    seq.mkdir(parents=True)
    for i in range(5):
        _rgb(seq / ("frame-%06d.color.png" % i), 64, 48, seed=20 + i)
        written["7scenes", i] = _depth16(
            seq / ("frame-%06d.depth.png" % i), 64, 48, seed=20 + i,
            sentinel=True)
        _pose(seq / ("frame-%06d.pose.txt" % i), 0.02 * i)
    scene = f"{KITTI_DATE}_drive_{KITTI_DRIVE}_sync"
    date_dir = root / "kitti" / "rawdata" / KITTI_DATE
    img_dir = date_dir / scene / "image_02" / "data"
    oxts_dir = date_dir / scene / "oxts" / "data"
    for d in (img_dir, oxts_dir):
        d.mkdir(parents=True)
    R9 = " ".join(map(str, np.eye(3).reshape(-1)))
    (date_dir / "calib_imu_to_velo.txt").write_text(
        f"calib_time: 25-May-2012 12:42:29\nR: {R9}\nT: -0.81 0.32 -0.8\n")
    (date_dir / "calib_velo_to_cam.txt").write_text(
        f"R: {R9}\nT: -0.004 -0.076 -0.27\n")
    P = [721.5, 0, 609.6, 44.9, 0, 721.5, 172.9, 0.2, 0, 0, 1, 0.003]
    (date_dir / "calib_cam_to_cam.txt").write_text(
        f"R_rect_00: {R9}\nP_rect_02: " + " ".join(map(str, P)) + "\n")
    for split in ("train", "val"):
        (root / "kitti" / split / scene / "proj_depth" / "groundtruth" /
         "image_02").mkdir(parents=True)
    for i in range(6):
        _rgb(img_dir / ("%010d.png" % i), KITTI_RAW_W, KITTI_RAW_H, 30 + i)
        (oxts_dir / ("%010d.txt" % i)).write_text(" ".join(map(str, list(
            _PACKETS[i % 3]) + [0.1 * i] * 24)))
        for split in ("train", "val"):
            written["kitti", split, i] = _depth16(
                root / "kitti" / split / scene / "proj_depth" /
                "groundtruth" / "image_02" / ("%010d.png" % i), KITTI_RAW_W,
                KITTI_RAW_H, 40 + i, lo=0, hi=80 * 256)
    return root, written


SPLITS = {"scannet": [[SCENE, "2"], [SCENE, "3"], [SCENE, "0"]],
          "7scenes": [["chess", "3", "2"], ["chess", "3", "3"]],
          "kitti": [[KITTI_DATE, KITTI_DRIVE, "val", "2"],
                    [KITTI_DATE, KITTI_DRIVE, "train", "3"],
                    [KITTI_DATE, KITTI_DRIVE, "train", "2"]]}


@pytest.fixture
def splits(monkeypatch):
    """Both packages' split readers give the tree's entries."""
    for mods, key in (((jscannet, scannet), "scannet"),
                      ((jsevenscenes, sevenscenes), "7scenes"),
                      ((jkitti, kitti), "kitti")):
        for mod in mods:
            monkeypatch.setattr(mod, "load_split",
                                lambda f, key=key: SPLITS[key])
    jkitti.load_calib.cache_clear()
    kitti.load_calib.cache_clear()


def _args(root, name, **kw):
    path = {"scannet": "scannet", "7scenes": "7scenes",
            "kitti_eigen": "kitti", "kitti_official": "kitti"}[name]
    d = dict(dataset_name=name,
             dataset_path=str(root / path) if root else "none",
             input_width=40, input_height=32, dpv_width=10, dpv_height=8,
             MAGNET_num_source_views=2, MAGNET_window_radius=2,
             batch_size=2, workers=1, seed=3, crop_height=24, crop_width=32)
    if name.startswith("kitti"):
        d.update(input_width=1216, input_height=352, dpv_width=304,
                 dpv_height=88, crop_height=352, crop_width=704)
    d.update(kw)
    return argparse.Namespace(**d)


def _assert_batches_equal(mine, theirs):
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b[k].dtype, k
                np.testing.assert_array_equal(v, b[k], err_msg=k)
            else:
                assert v == b[k], k


def _both(kind, args, mode, epochs=1):
    """Two epochs' batches of the port's and the JAX package's loader."""
    out = []
    for make in ((tdata, jdata)):
        loader = getattr(make, f"make_{kind}_loader")(args, mode)
        out.append([b for _ in range(epochs) for b in loader])
    return out


# ---- the helpers of data/base.py ---------------------------------------

def _helper_cases(tmp):
    rng = np.random.RandomState(0)
    img = rng.rand(30, 40, 3).astype(np.float32)
    depth = rng.uniform(0.5, 9.0, (30, 40)).astype(np.float32)
    _rgb(tmp / "c.jpg", 50, 40, seed=1)
    _rgb(tmp / "c.png", 50, 40, seed=2)
    _depth16(tmp / "d.png", 50, 40, seed=3, sentinel=True)
    _pose(tmp / "p.txt", 0.3)
    return {
        "load_image": lambda b: [b.load_image(str(tmp / "c.jpg")),
                                 b.load_image(str(tmp / "c.png"), (33, 21))],
        "load_depth_png": lambda b: [
            b.load_depth_png(str(tmp / "d.png"), 1000.0),
            b.load_depth_png(str(tmp / "d.png"), 256.0, (33, 21), 65535)],
        "read_matrix_txt": lambda b: [b.read_matrix_txt(str(tmp / "p.txt")),
                                      b.read_matrix_txt(str(tmp / "p.txt"),
                                                        invert=True)],
        "color_augment": lambda b: [b.color_augment(
            img, 1.07, 0.8, np.array([0.95, 1.02, 1.1], np.float32))],
        "draw_color_aug": lambda b: [
            b.draw_color_aug(np.random.RandomState(s), (0.75, 1.25))
            for s in range(8)],
        "window_indices": lambda b: [b.window_indices(v, r)
                                     for v, r in ((2, 2), (4, 10), (4, 20))],
        "fallback_index": lambda b: [
            b.fallback_index(i, o, 5, lambda j: 0 <= j < 12)
            for i in (0, 3, 11) for o in (-10, -5, 5, 10)],
        "rotate_pair": lambda b: [b.rotate_pair(img, depth, a)
                                  for a in (-2.5, 0.7, 1.9)],
        "random_crop_pair": lambda b: [b.random_crop_pair(
            np.random.RandomState(s), img, depth, 24, 32) for s in range(3)],
    }


HELPERS = ("load_image", "load_depth_png", "read_matrix_txt",
           "color_augment", "draw_color_aug", "window_indices",
           "fallback_index", "rotate_pair", "random_crop_pair")


def _assert_equal_nested(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_nested(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("helper", HELPERS)
def test_helper_matches_jax(helper, tmp_path):
    cases = _helper_cases(tmp_path)
    got, want = cases[helper](base), cases[helper](jbase)
    _assert_equal_nested(got, want)
    if helper == "load_depth_png":
        assert got[1].min() == 0.0             # the sentinel reads as 0


# ---- datasets on disk against the JAX package ----------------------------

@pytest.mark.parametrize("workers", [1, 4])
def test_scannet_multiview_matches_jax(trees, splits, workers):
    """Evaluation (long_test) and training (the split replaced; one colour
    augmentation a sample), two epochs; every depth equals the written
    uint16 / 1000 of its reference frame at the input size."""
    root, written = trees
    args = _args(root, "scannet", workers=workers)
    for mode in ("train", "long_test"):
        mine, theirs = _both("multiview", args, mode, epochs=2)
        _assert_batches_equal(mine, theirs)
    first = mine[0]
    assert first["view_ids"] == [[f"{SCENE}/2", f"{SCENE}/0", f"{SCENE}/4"]]
    want = np.asarray(Image.fromarray(written["scans_test", 2]).resize(
        (40, 32), Image.NEAREST)).astype(np.float32) / 1000.0
    np.testing.assert_array_equal(first["depth"][0], want)
    assert first["is_valid"].all() and np.isfinite(first["R"]).all()


@pytest.mark.parametrize("workers", [1, 4])
def test_scannet_singleview_matches_jax(trees, splits, workers):
    """Training with rotate, flip, crop and colour, two epochs; evaluation
    at the input size."""
    root, _ = trees
    args = _args(root, "scannet", workers=workers)
    mine, theirs = _both("singleview", args, "train", epochs=2)
    _assert_batches_equal(mine, theirs)
    assert mine[0]["img"].shape == (2, 24, 32, 3)
    assert len({b["img"].tobytes() for b in mine}) == len(mine)
    _assert_batches_equal(*_both("singleview", args, "long_test"))


def test_sevenscenes_matches_jax(trees, splits):
    """Multi-view and single-view; the 65535 sentinel reads as 0."""
    root, written = trees
    args = _args(root, "7scenes", input_width=64, input_height=48)
    mine, theirs = _both("multiview", args, "test")
    _assert_batches_equal(mine, theirs)
    d = written["7scenes", 2]
    np.testing.assert_array_equal(
        mine[0]["depth"][0],
        np.where(d == 65535, 0, d).astype(np.float32) / 1000.0)
    assert (mine[0]["depth"][0] == 0).any()
    _assert_batches_equal(*_both("singleview", args, "long_test"))


def test_kitti_multiview_matches_jax(trees, splits):
    """eigen_test: the kb-crop, the intrinsics it shifts, the OXTS poses;
    depth = uint16 / 256 inside the crop."""
    root, written = trees
    args = _args(root, "kitti_eigen")
    mine, theirs = _both("multiview", args, "eigen_test")
    _assert_batches_equal(mine, theirs)
    b = mine[0]
    assert b["ref_img"].shape == (1, 352, 1216, 3)
    assert b["rays2d"].shape == (1, 3, 88 * 304)
    top, left = KITTI_RAW_H - 352, (KITTI_RAW_W - 1216) // 2
    np.testing.assert_array_equal(
        b["depth"][0], written["kitti", "val", 2][
            top:top + 352, left:left + 1216].astype(np.float32) / 256.0)
    assert b["is_valid"].all() and np.isfinite(b["t"]).all()


@pytest.mark.parametrize("workers", [1, 4])
def test_kitti_singleview_matches_jax(trees, splits, workers):
    """eigen_train augments (the crop is 352x704); official_train does not
    (the reference's quirk), so its items keep the kb-crop's 352x1216."""
    root, _ = trees
    for name, mode, shape in (("kitti_eigen", "eigen_train", (352, 704)),
                              ("kitti_official", "official_train",
                               (352, 1216))):
        args = _args(root, name, workers=workers)
        mine, theirs = _both("singleview", args, mode)
        _assert_batches_equal(mine, theirs)
        assert mine[0]["img"].shape == (2,) + shape + (3,)


def test_oxts_poses_match_jax():
    """On tests/test_oxts_golden.py's packets: the JAX package's poses bit
    for bit, and the golden matrices at that file's tolerances."""
    rows = [np.array(list(p) + [0.0] * 24) for p in _PACKETS]
    got, want = kitti.oxts_poses(rows), jkitti.oxts_poses(rows)
    for T, J, G in zip(got, want, _GOLDEN):
        np.testing.assert_array_equal(T, J)
        np.testing.assert_allclose(T[:3, :3], G[:3, :3], atol=1e-9)
        np.testing.assert_allclose(T[:3, 3], G[:3, 3], atol=1e-5)


def test_scannet_train_split_is_missing():
    """data_split/scannet_train.txt is not in the repository: ScanNet
    training names it, in the port as in the JAX package."""
    args = _args(None, "scannet")
    for make in (tdata, jdata):
        with pytest.raises(FileNotFoundError, match="scannet_train.txt"):
            make.make_multiview_loader(args, "train")
        with pytest.raises(FileNotFoundError, match="scannet_train.txt"):
            make.make_singleview_loader(args, "train")


def test_entry_points_on_a_scannet_tree(trees, splits, tmp_path,
                                        monkeypatch):
    """The four entry points end to end on the CPU from the ScanNet tree
    (each split replaced by its first entry), at 32x32, with
    ``--DNET_architecture DenseDepth_GN``: ``train_dnet`` (an augmented
    training item, a 32x32 crop of a 40x32 frame), ``test_dnet`` and
    ``train_magnet`` from its checkpoint, ``test_magnet`` from that run's."""
    root, _ = trees
    monkeypatch.setattr(scannet, "load_split",
                        lambda f: SPLITS["scannet"][:1])
    common = ["--exp_dir", str(tmp_path), "--dataset_name", "scannet",
              "--dataset_path", str(root / "scannet"), "--device", "cpu",
              "--input_height", "32", "--DNET_architecture",
              "DenseDepth_GN"]
    dnet = ["--output_dim", "2", "--output_type", "G"]
    out = train_dnet.main(common + dnet + [
        "--exp_name", "d", "--input_width", "40", "--crop_height", "32",
        "--crop_width", "32", "--batch_size", "1", "--n_epochs", "1",
        "--workers", "2", "--compute_dtype", "float32"])
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 1
    assert isinstance(out["state"].model.d_net.decoder.up1, UpSampleGN)
    m = test_dnet.main(common + dnet + [
        "--exp_name", "e", "--input_width", "32", "--ckpt_path",
        out["ckpt"]])
    assert len(m) == 12 and all(np.isfinite(v) for v in m.values())
    magnet = ["--input_width", "32", "--dpv_height", "8", "--dpv_width",
              "8", "--MAGNET_num_source_views", "2", "--MAGNET_window_radius",
              "2", "--FNET_feature_dim", "16", "--DNET_ckpt", out["ckpt"],
              "--FNET_ckpt", ""]
    mt = train_magnet.main(common + magnet + [
        "--exp_name", "t", "--batch_size", "1", "--n_epochs", "1",
        "--workers", "1", "--compute_dtype", "float32"])
    assert np.isfinite(mt["losses"]).all() and len(mt["losses"]) == 1
    m = test_magnet.main(common + magnet + ["--exp_name", "m",
                                            "--MAGNET_ckpt", mt["ckpt"]])
    assert len(m) == 12 and all(np.isfinite(v) for v in m.values())
    lines = (tmp_path / "m" / "log" / "test_acc.txt").read_text()
    assert "dataset: scannet" in lines


def _train_dnet_args(extra=()):
    return config.parse_args(config.build_train_dnet_parser(), [
        "--exp_name", "t", "--exp_dir", "unused", "--output_dim", "2",
        "--output_type", "G", "--DNET_architecture", "DenseDepth_BN",
        "--dataset_name", "synthetic", "--dataset_path", "none",
        "--input_height", "24", "--input_width", "40", "--crop_height", "16",
        "--crop_width", "16", "--batch_size", "2", "--synthetic_length", "5",
        "--seed", "2"] + list(extra))


@pytest.mark.parametrize("workers", ["1", "4"])
def test_synthetic_training_batches_match_jax(workers):
    """The synthetic single-view training loader draws at the input size,
    not at the crop, as the JAX package does: the port's batches equal the
    JAX ``Loader``'s, two epochs, bit for bit."""
    args = _train_dnet_args(["--workers", workers])
    mine, theirs = _both("singleview", args, "train", epochs=2)
    _assert_batches_equal(mine, theirs)
    assert mine[0]["img"].shape == (2, 24, 40, 3) and len(mine) == 4
    assert mine[0]["depth"].min() >= 0.5
