"""Learned convex upsampling by k, NHWC.

The port of ``magnet_tpu/kernels/upsample_pallas.py::
upsample_via_mask_pallas``: each full-resolution pixel is a softmax-weighted
convex combination of the zero-padded 3x3 coarse neighbourhood of its parent
pixel. The mask channel index is ``c = j * k * k + ki * k + kj`` with
``j = ky * 3 + kx`` (the reference's ``view(N, 1, 9, k, k, H, W)``). The CUDA
kernel (``csrc/upsample_mask.cu``) does the softmax, the combine and the
k x k pixel shuffle in one pass, for up to ``MAX_MAPS`` maps that share the
mask (MaGNet's iterations) in one launch; bounded by bytes on an H100, see
the source note.

``upsample_mask_ref`` is the plain PyTorch version. ``upsample_mask`` runs it
for tensors on the CPU and launches the kernel for tensors on a CUDA device,
or raises. Both take one map or a sequence of maps, and a map's output is
the same, bit for bit, whichever maps it comes with.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_MAPS = 4          # maps a launch (csrc/upsample_mask.cu: UP_MAX_MAPS)
Maps = Union[torch.Tensor, Sequence[torch.Tensor]]


def _convex(weights: torch.Tensor, depth: torch.Tensor, k: int
            ) -> torch.Tensor:
    """One map through the softmaxed (B, H, W, 9, k, k) weights."""
    B, H, W, C = depth.shape
    # (B, C*9, H*W) zero-padded 3x3 neighbourhoods, j = ky*3 + kx
    nb = F.unfold(depth.float().permute(0, 3, 1, 2), 3, padding=1)
    nb = nb.reshape(B, C, 9, H, W).permute(0, 3, 4, 2, 1)  # (B,H,W,9,C)
    out = torch.einsum("bhwjkl,bhwjc->bhkwlc", weights, nb)
    return out.reshape(B, H * k, W * k, C).to(depth.dtype)


def upsample_mask_ref(depth: Maps, up_mask: torch.Tensor, k: int) -> Maps:
    """Plain version. depth: (B, H, W, C), or a sequence of such maps;
    up_mask: (B, H, W, 9*k*k). Returns (B, k*H, k*W, C) in depth's dtype
    (a list for a sequence), computed in f32, the softmax once for all
    maps."""
    single = isinstance(depth, torch.Tensor)
    maps = [depth] if single else list(depth)
    B, H, W = maps[0].shape[:3]
    weights = up_mask.float().reshape(B, H, W, 9, k, k).softmax(dim=3)
    outs = [_convex(weights, d, k) for d in maps]
    return outs[0] if single else outs


def upsample_mask(depth: Maps, up_mask: torch.Tensor, k: int) -> Maps:
    """Convex upsampling with the arguments of ``upsample_mask_ref``. CPU
    tensors take the plain version; CUDA tensors (f32 or bf16, maps and
    mask of one dtype, the maps of one shape) launch the kernel on the
    current stream, once for every ``MAX_MAPS`` maps."""
    single = isinstance(depth, torch.Tensor)
    maps = [depth] if single else list(depth)
    if not maps:
        raise ValueError("upsample_mask: no map")
    if maps[0].device.type == "cpu":
        return upsample_mask_ref(depth, up_mask, k)
    d0 = maps[0]
    if d0.device.type != "cuda":
        raise ValueError(f"upsample_mask: unsupported device {d0.device}")
    dt, dev = d0.dtype, d0.device
    if dt not in _DTYPES:
        raise ValueError(f"upsample_mask: unsupported dtype {dt}")
    if d0.dim() != 4:
        raise ValueError("upsample_mask: depth must be (B, H, W, C)")
    B, H, W, C = d0.shape
    for d in maps:
        if (d.shape != d0.shape or d.dtype != dt or d.device != dev
                or not d.is_contiguous()):
            raise ValueError(f"upsample_mask: every map must be contiguous "
                             f"{tuple(d0.shape)} {dt} on {dev}")
    if (tuple(up_mask.shape) != (B, H, W, 9 * k * k) or up_mask.dtype != dt
            or up_mask.device != dev or not up_mask.is_contiguous()):
        raise ValueError(f"upsample_mask: up_mask must be contiguous "
                         f"{(B, H, W, 9 * k * k)} {dt} on {dev}")
    outs = [torch.empty((B, H * k, W * k, C), dtype=dt, device=dev)
            for _ in maps]
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i in range(0, len(maps), MAX_MAPS):
        ins = [d.data_ptr() for d in maps[i:i + MAX_MAPS]]
        res = [o.data_ptr() for o in outs[i:i + MAX_MAPS]]
        n = len(ins)
        with torch.cuda.device(dev):
            err = lib.mt_upsample_mask(
                _DTYPES[dt], n, *(ins + [None] * (MAX_MAPS - n)),
                up_mask.data_ptr(), *(res + [None] * (MAX_MAPS - n)),
                B, H, W, C, k, stream)
        build.check(err, "upsample_mask")
        upsample_mask.launches += 1
    return outs[0] if single else outs


upsample_mask.launches = 0
