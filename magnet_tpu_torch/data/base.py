"""Input pipeline: image normalisation and a deterministic batch loader.

The port's copy of the parts of ``magnet_tpu/data/base.py`` that the
evaluation and training paths need. Datasets are plain objects with
``__len__`` and ``get(idx)``; ``Loader`` yields them as numpy batches: in
order for evaluation (batch 1 by default), shuffled per epoch for training.

Item schema, multi-view: ref_img (H, W, 3) f32 ImageNet-normalised; src_imgs
(V, H, W, 3); depth (H, W) of the reference frame, 0 where invalid; R, t
(V, 3, 3), (V, 3) relative poses source <- reference; is_valid (V,); intM
(3, 3) intrinsics at cost-volume resolution; rays2d (3, h*w) unit rays;
view_ids, one string a frame (reference first), the streaming cache's keys.
Single-view: img (H, W, 3), depth (H, W). ``collate`` stacks the arrays of
either and lists the rest (``view_ids`` as a list of lists).
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
    """Batches of a dataset as collated numpy arrays, in the caller's thread.

    train=True: a fresh permutation each epoch from
    ``RandomState((seed, epoch))``, the last partial batch dropped — the
    indices of the JAX package's loader on one host. train=False: index
    order, the last batch kept (batch 1 is the reference's evaluation
    protocol)."""

    def __init__(self, dataset, batch_size: int = 1, train: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.train:
            idx = np.random.RandomState((self.seed, self.epoch)).permutation(n)
            return idx[:len(self) * self.batch_size]
        return np.arange(n)

    def __len__(self) -> int:
        if self.train:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        self.epoch += 1
        for i in range(0, len(idx), self.batch_size):
            yield collate([self.dataset.get(int(j))
                           for j in idx[i:i + self.batch_size]])
