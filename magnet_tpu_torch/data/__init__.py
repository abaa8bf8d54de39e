"""The datasets' dispatch, the one the entry points call.

The port's copy of ``magnet_tpu/data/__init__.py``. ``mode`` names the
split (``long_test``, ``eigen_train``, ...; ``train`` or ``test`` for the
synthetic dataset); a mode containing "train" gives the shuffled,
augmented training loader at ``--batch_size`` on ``--workers`` threads, any
other the evaluation loader at batch 1.
"""

from magnet_tpu_torch.data import kitti, scannet, sevenscenes, synthetic


def make_multiview_loader(args, mode: str):
    """Dataset dispatch by name (test_MaGNet.py:174-187)."""
    name = args.dataset_name
    if name == "synthetic":
        return scannet._make_loader(synthetic.SyntheticMultiView(args),
                                    args, mode)
    if name == "scannet":
        return scannet.ScanNetMultiViewLoader(args, mode)
    if name == "7scenes":
        return sevenscenes.SevenScenesMultiViewLoader(args, mode)
    if name in ("kitti_eigen", "kitti_official"):
        return kitti.KittiMultiViewLoader(args, mode)
    raise ValueError(f"unknown dataset {name!r}")


def make_singleview_loader(args, mode: str):
    """Dataset dispatch for the D-Net (train_DNet.py:28-41, test_DNet.py)."""
    name = args.dataset_name
    if name == "synthetic":
        return scannet._make_loader(synthetic.SyntheticSingleView(args),
                                    args, mode)
    if name == "scannet":
        return scannet.ScanNetSingleViewLoader(args, mode)
    if name == "7scenes":
        return sevenscenes.SevenScenesSingleViewLoader(args, mode)
    if name in ("kitti_eigen", "kitti_official"):
        return kitti.KittiSingleViewLoader(args, mode)
    raise ValueError(f"unknown dataset {name!r}")


# the split of each dataset that an entry point reads: evaluation
# (test_MaGNet.py:17-20; test_DNet.py reads 7-Scenes' one split as
# long_test), training and the validation during training
# (train_DNet.py:25-28, train_FNet.py, train_MaGNet.py). 7-Scenes has no
# training split.
TEST_MODES = {"scannet": "long_test", "7scenes": "test",
              "kitti_eigen": "eigen_test", "kitti_official": "official_test",
              "synthetic": "test"}
TRAIN_MODES = {"scannet": "train", "kitti_eigen": "eigen_train",
               "kitti_official": "official_train", "synthetic": "train"}
VAL_MODES = {"scannet": "long_test", "kitti_eigen": "eigen_test",
             "kitti_official": "official_test", "synthetic": "test"}
