"""Input pipeline: readers, training augmentations and a deterministic,
prefetching batch loader.

The port's copy of ``magnet_tpu/data/base.py``: the same PIL and numpy calls
in the same order, so that a file or a seed gives the same arrays in both
packages, bit for bit. Datasets are plain objects with ``__len__`` and
``get(idx, rng)``; ``Loader`` shuffles per epoch, takes a host's slice of
the permutation, gives each item its own ``RandomState`` and collates numpy
batches, loading them on a thread pool ahead of the caller. PIL is imported
inside the readers: a model path never needs it.

Item schema, multi-view: ref_img (H, W, 3) f32 ImageNet-normalised; src_imgs
(V, H, W, 3); depth (H, W) of the reference frame, 0 where invalid; R, t
(V, 3, 3), (V, 3) relative poses source <- reference; is_valid (V,); intM
(3, 3) intrinsics at cost-volume resolution; rays2d (3, h*w) unit rays;
view_ids, one string a frame (reference first), the streaming cache's keys.
Single-view: img (H, W, 3), depth (H, W). ``collate`` stacks the arrays of
either and lists the rest (``view_ids`` as a list of lists).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """[0,1] (H, W, 3) -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def load_image(path: str, size=None) -> np.ndarray:
    """RGB image as float32 (H, W, 3) in [0,1]; optional bilinear resize to
    (W, H)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size=size, resample=Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_depth_png(path: str, scale: float, size=None,
                   sentinel: Optional[int] = None) -> np.ndarray:
    """uint16 depth png (mode ``I;16``) -> float32 (H, W) metres; optional
    nearest resize; ``sentinel`` values (7-Scenes' 65535) zeroed before
    scaling."""
    from PIL import Image
    d = Image.open(path)
    if size is not None:
        d = d.resize(size=size, resample=Image.NEAREST)
    d = np.asarray(d)
    if d.ndim == 3:
        d = d[..., 0]
    d = d.astype(np.int64)
    if sentinel is not None:
        d[d == sentinel] = 0
    return d.astype(np.float32) / scale


def read_matrix_txt(path: str, invert: bool = False) -> np.ndarray:
    """4x4 matrix from whitespace text; ``invert`` for cam2world ->
    world2cam (dataloader_scannet.py:16-27)."""
    m = np.eye(4)
    with open(path) as f:
        rows = [r.split() for r in f.read().strip().splitlines()]
    for i in range(4):
        m[i, :] = [float(x) for x in rows[i][:4]]
    if invert:
        m = np.linalg.inv(m)
    return m


def color_augment(img: np.ndarray, gamma: float, brightness: float,
                  colors: np.ndarray) -> np.ndarray:
    """Joint gamma/brightness/per-channel color jitter, clipped to [0,1]
    (dataloader_scannet.py:219-232). One parameter draw is shared by all
    frames of a multi-view sample."""
    out = (img ** gamma) * brightness * colors[None, None, :]
    return np.clip(out, 0.0, 1.0)


def draw_color_aug(rng: np.random.RandomState, brightness_range):
    """(gamma, brightness, colors) or None with p=0.5
    (dataloader_scannet.py:172-178; KITTI's brightness range differs,
    dataloader_kitti.py:146-148)."""
    if rng.rand() <= 0.5:
        return None
    return (rng.uniform(0.9, 1.1), rng.uniform(*brightness_range),
            rng.uniform(0.9, 1.1, size=3).astype(np.float32))


def window_indices(n_views: int, window_radius: int) -> List[int]:
    """Source-view offsets: +-window_radius in n_views//2 steps per side
    (dataloader_scannet.py:87-94), and the step. Offset 0 is the
    reference."""
    interval = window_radius // (n_views // 2)
    return [i * interval
            for i in range(-n_views // 2, n_views // 2 + 1)], interval


def fallback_index(img_idx: int, offset: int, interval: int,
                   exists) -> int:
    """Existence-checked neighbour index with the reference's mirror
    fallback (dataloader_scannet.py:161-166)."""
    if exists(img_idx + offset):
        return img_idx + offset
    return img_idx - offset - int(np.sign(offset)) * int(interval * 0.5)


def rotate_pair(img: np.ndarray, depth: np.ndarray, degrees: float):
    """Random-rotate augmentation through PIL: bilinear for the image (via
    uint8), nearest for the depth (dataloader_scannet_D.py:86-90)."""
    from PIL import Image
    im = Image.fromarray((img * 255).astype(np.uint8)).rotate(
        degrees, resample=Image.BILINEAR)
    dm = Image.fromarray(depth).rotate(degrees, resample=Image.NEAREST)
    return np.asarray(im, np.float32) / 255.0, np.asarray(dm, np.float32)


def random_crop_pair(rng, img, depth, crop_h, crop_w):
    """The same random crop_h x crop_w window of the image and the depth."""
    y = rng.randint(0, img.shape[0] - crop_h + 1)
    x = rng.randint(0, img.shape[1] - crop_w + 1)
    return (img[y:y + crop_h, x:x + crop_w],
            depth[y:y + crop_h, x:x + crop_w])


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
    """Deterministic sharded shuffling, per-item random state and threaded
    prefetch.

    train=True: a fresh permutation each epoch from ``RandomState((seed,
    epoch))``; host ``host_index`` of ``host_count`` takes
    ``indices[host_index::host_count]``; the last partial batch is dropped.
    train=False: index order, the last batch kept (batch 1 is the
    reference's evaluation protocol). Item j of batch bi gets
    ``RandomState((base_seed + bi * batch_size + j) & 0x7FFFFFFF)`` with
    ``base_seed = hash((seed, epoch)) & 0x7FFFFFFF``, whichever thread loads
    it, so the batches do not depend on ``num_workers``. With more than one
    worker, up to ``num_workers * prefetch`` batches load ahead of the
    caller, and they are yielded in order.

    Rank ``shard_index`` of ``shard_count`` training processes (the port's
    data parallelism, ``core/mesh.py``) loads only its contiguous
    ``batch_size / shard_count`` items of each global batch, each with the
    random state above (j its place in the global batch): the ranks'
    batches, put together, are the one-process batch.
    """

    def __init__(self, dataset, batch_size: int = 1, train: bool = False,
                 seed: int = 0, num_workers: int = 4,
                 host_index: int = 0, host_count: int = 1,
                 prefetch: int = 2, shard_index: int = 0,
                 shard_count: int = 1):
        if batch_size % shard_count:
            raise ValueError(f"a batch of {batch_size} does not divide over "
                             f"{shard_count} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.host_index = host_index
        self.host_count = host_count
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.train:
            rng = np.random.RandomState((self.seed, self.epoch))
            idx = rng.permutation(n)
            idx = idx[self.host_index::self.host_count]
            n_batches = len(idx) // self.batch_size
            return idx[:n_batches * self.batch_size]
        return np.arange(n)

    def __len__(self) -> int:
        if self.train:
            per_host = len(self.dataset) // self.host_count
            return per_host // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        bs = self.batch_size
        batches = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        base_seed = hash((self.seed, self.epoch)) & 0x7FFFFFFF
        self.epoch += 1
        share = bs // self.shard_count
        first = self.shard_index * share

        def load_batch(bi_batch):
            bi, batch_idx = bi_batch
            items = []
            for j, di in enumerate(batch_idx):
                if self.shard_count > 1 and not first <= j < first + share:
                    continue
                rng = np.random.RandomState(
                    (base_seed + bi * bs + j) & 0x7FFFFFFF)
                items.append(self.dataset.get(int(di), rng))
            return collate(items)

        if self.num_workers <= 1:
            yield from map(load_batch, enumerate(batches))
            return

        with ThreadPoolExecutor(self.num_workers) as pool:
            window = self.num_workers * max(1, self.prefetch)
            futures = []
            for item in enumerate(batches):
                futures.append(pool.submit(load_batch, item))
                if len(futures) >= window:
                    yield futures.pop(0).result()
            for f in futures:
                yield f.result()
