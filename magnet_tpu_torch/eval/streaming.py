"""Streaming (feature-cached) MaGNet inference for video, PyTorch.

The port of ``magnet_tpu/eval/streaming.py``. The evaluation protocol runs
the frozen D-Net and F-Net on every frame of every window, so in a video each
frame is encoded about V + 1 times: once as the reference and V times as a
source of nearby windows, although what the trunks give depends on the frame
alone. ``FrameEncodingCache`` keeps ``Magnet.encode``'s outputs in an LRU
keyed by the loader's ``view_ids``, so that in steady state a window costs
one trunk pass (its new frame) and one fusion; the fusion takes the same
tensors as in the monolithic forward.

Each frame is encoded at batch 1 where the monolithic forward encodes the
window's V + 1 frames together; a kernel whose plan depends on the batch
may round differently (``PERF.md``). Evaluation only: training draws
augmentations per sample, which makes a frame's pixels sample-dependent.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Tuple

import numpy as np
import torch

GEOMETRY_KEYS = ("R", "t", "is_valid", "intM", "rays2d")


class FrameEncodingCache:
    """LRU of per-frame encodings, at most ``max_frames`` of them (one
    480x640 encoding is about 12 MB in bf16: the Gaussian, the 256-channel
    decoder feature and the 64-channel matching feature at 120x160)."""

    def __init__(self, encode: Callable, max_frames: int = 48):
        self._encode = encode
        self._max = max_frames
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, frame_id: str, img):
        """img: a (1, H, W, 3) frame; its encoding, made on a miss."""
        if frame_id in self._entries:
            self._entries.move_to_end(frame_id)
            self.hits += 1
            return self._entries[frame_id]
        enc = self._encode(img)
        self.misses += 1
        self._entries[frame_id] = enc
        while len(self._entries) > self._max:
            self._entries.popitem(last=False)
        return enc

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


def make_streaming_forward(model: torch.nn.Module, dtype: torch.dtype,
                           device: torch.device, n_iters: int,
                           max_frames: int = 48
                           ) -> Tuple[Callable[[Dict], np.ndarray],
                                      FrameEncodingCache]:
    """``forward(batch) -> the last iteration's (1, H, W, 2)`` (f32 numpy)
    for ``eval/harness.evaluate_magnet`` that encodes each distinct frame
    once, and its cache. ``model``: a ``Magnet`` in eval mode, cast as
    ``build.cast_for_inference`` leaves it; images go to ``dtype``, the
    geometry stays f32. The batch must hold one sample and its
    ``view_ids`` (reference first, then the sources)."""

    @torch.inference_mode()
    def encode(img) -> tuple:
        return model.encode(torch.from_numpy(np.asarray(img)).to(
            device=device, dtype=dtype))

    cache = FrameEncodingCache(encode, max_frames=max_frames)

    @torch.inference_mode()
    def forward(batch: Dict) -> np.ndarray:
        ref_img = np.asarray(batch["ref_img"])
        src_imgs = np.asarray(batch["src_imgs"])
        if src_imgs.shape[0] != 1:
            raise ValueError("streaming eval requires batch size 1")
        ids = batch["view_ids"][0]
        V = src_imgs.shape[1]
        if len(ids) != V + 1:
            raise ValueError(f"view_ids has {len(ids)} entries for "
                             f"{V} source views")
        ref_gauss, ref_fd, ref_fm = cache.get(ids[0], ref_img)
        src = [cache.get(ids[1 + i], src_imgs[:, i]) for i in range(V)]
        src_gauss = torch.stack([e[0][0] for e in src])[None]
        src_feat = torch.stack([e[2][0] for e in src])[None]
        geo = [torch.from_numpy(np.asarray(batch[k], np.float32)).to(device)
               for k in GEOMETRY_KEYS]
        preds = model.fuse(ref_gauss, ref_fd, ref_fm, src_gauss, src_feat,
                           *geo, n_iters=n_iters)
        return preds[-1].float().cpu().numpy()

    return forward, cache
