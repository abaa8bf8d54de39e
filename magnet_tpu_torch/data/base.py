"""Input pipeline: image normalisation and a deterministic batch loader.

The port's copy of the parts of ``magnet_tpu/data/base.py`` that the
evaluation paths need. Datasets are plain objects with ``__len__`` and
``get(idx)``; ``Loader`` yields them as numpy batches of one, in order.

Item schema, multi-view: ref_img (H, W, 3) f32 ImageNet-normalised; src_imgs
(V, H, W, 3); depth (H, W) of the reference frame, 0 where invalid; R, t
(V, 3, 3), (V, 3) relative poses source <- reference; is_valid (V,); intM
(3, 3) intrinsics at cost-volume resolution; rays2d (3, h*w) unit rays.
Single-view: img (H, W, 3), depth (H, W). ``collate`` stacks the arrays of
either and lists the rest.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """[0,1] (H, W, 3) -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([it[k] for it in items])
        else:
            out[k] = [it[k] for it in items]
    return out


class Loader:
    """Batches of one item of a dataset, in index order (the reference's
    evaluation protocol runs at batch 1)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self.dataset)):
            yield collate([self.dataset.get(i)])
