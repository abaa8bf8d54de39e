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

The backward (``upsample_mask_bwd``, the same source) has no TPU
counterpart: the JAX package differentiates upsampling through XLA. Where
autograd needs it on the card, ``upsample_mask`` launches the forward inside
a ``torch.autograd.Function`` whose backward is that kernel, one launch for
the maps of a forward launch: the gradients of the coarse maps, and of the
mask logits with the maps' terms summed. Its plain version is autograd
through ``upsample_mask_ref`` (``upsample_mask_bwd_ref``), which CPU tensors
take.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import MAX_MAPS, OPS

_DTYPES = (torch.float32, torch.bfloat16)
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


def upsample_mask_bwd_ref(grads: Sequence[torch.Tensor],
                          depth: Sequence[torch.Tensor],
                          up_mask: torch.Tensor, k: int) -> tuple:
    """Plain version of the backward: autograd through
    ``upsample_mask_ref``. grads: the upstream gradients of the maps'
    outputs. Returns (the maps' gradients, the mask's), in their dtypes."""
    with torch.enable_grad():
        maps = [d.detach().requires_grad_() for d in depth]
        mask = up_mask.detach().requires_grad_()
        outs = upsample_mask_ref(maps, mask, k)
        got = torch.autograd.grad(outs, maps + [mask], list(grads))
    return list(got[:-1]), got[-1]


class _UpsampleMask(torch.autograd.Function):
    """The kernel's forward, and ``upsample_mask_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, k, up_mask, *maps):
        ctx.k = k
        ctx.save_for_backward(up_mask, *maps)
        return tuple(_launch(list(maps), up_mask, k))

    @staticmethod
    def backward(ctx, *grads):
        up_mask, *maps = ctx.saved_tensors
        gmaps, gmask = upsample_mask_bwd(grads, maps, up_mask, ctx.k)
        return (None, gmask, *gmaps)


def upsample_mask(depth: Maps, up_mask: torch.Tensor, k: int) -> Maps:
    """Convex upsampling with the arguments of ``upsample_mask_ref``. CPU
    tensors take the plain version; CUDA tensors (f32 or bf16, maps and
    mask of one dtype, the maps of one shape) launch the kernel on the
    current stream, once for every ``MAX_MAPS`` maps. Where autograd
    records, the launches go through ``_UpsampleMask``, whose backward is
    ``upsample_mask_bwd`` (at most ``MAX_MAPS`` maps then)."""
    single = isinstance(depth, torch.Tensor)
    maps = [depth] if single else list(depth)
    if not maps:
        raise ValueError("upsample_mask: no map")
    if maps[0].device.type == "cpu":
        return upsample_mask_ref(depth, up_mask, k)
    _check(maps, up_mask, k, "upsample_mask")
    if torch.is_grad_enabled() and (up_mask.requires_grad or any(
            d.requires_grad for d in maps)):
        if len(maps) > MAX_MAPS:
            raise ValueError(f"upsample_mask: the backward takes at most "
                             f"{MAX_MAPS} maps")
        outs = list(_UpsampleMask.apply(k, up_mask, *maps))
    else:
        outs = _launch(maps, up_mask, k)
    return outs[0] if single else outs


def _check(maps, up_mask, k, what):
    """Raise unless the maps and the mask are what the kernels take."""
    d0 = maps[0]
    if d0.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {d0.device}")
    dt, dev = d0.dtype, d0.device
    if dt not in _DTYPES:
        raise ValueError(f"{what}: unsupported dtype {dt}")
    if d0.dim() != 4:
        raise ValueError(f"{what}: depth must be (B, H, W, C)")
    B, H, W, C = d0.shape
    for d in maps:
        if (d.shape != d0.shape or d.dtype != dt or d.device != dev
                or not d.is_contiguous()):
            raise ValueError(f"{what}: every map must be contiguous "
                             f"{tuple(d0.shape)} {dt} on {dev}")
    if (tuple(up_mask.shape) != (B, H, W, 9 * k * k) or up_mask.dtype != dt
            or up_mask.device != dev or not up_mask.is_contiguous()):
        raise ValueError(f"{what}: up_mask must be contiguous "
                         f"{(B, H, W, 9 * k * k)} {dt} on {dev}")


def _launch(maps, up_mask, k):
    """The forward kernel on checked CUDA tensors, once for every
    ``MAX_MAPS`` maps (``ops.upsample_mask``)."""
    outs = []
    for i in range(0, len(maps), MAX_MAPS):
        outs += OPS.upsample_mask(maps[i:i + MAX_MAPS], up_mask, k)
    return outs


def upsample_mask_bwd(grads: Sequence[torch.Tensor],
                      depth: Sequence[torch.Tensor], up_mask: torch.Tensor,
                      k: int) -> tuple:
    """The backward kernel, arguments as ``upsample_mask_bwd_ref``: CPU
    tensors take the plain version; CUDA tensors (up to ``MAX_MAPS`` maps
    of one shape and dtype with the mask, f32 or bf16; the gradients are
    cast to that dtype) launch it once on the current stream
    (``ops.upsample_mask_bwd``)."""
    maps = list(depth)
    if not maps:
        raise ValueError("upsample_mask_bwd: no map")
    if maps[0].device.type == "cpu":
        return upsample_mask_bwd_ref(grads, maps, up_mask, k)
    _check(maps, up_mask, k, "upsample_mask_bwd")
    if len(maps) > MAX_MAPS or len(grads) != len(maps):
        raise ValueError(f"upsample_mask_bwd: one gradient a map, at most "
                         f"{MAX_MAPS} maps")
    gmaps, gmask = OPS.upsample_mask_bwd([g.to(maps[0].dtype).contiguous()
                                         for g in grads], maps, up_mask, k)
    return list(gmaps), gmask


upsample_mask.launches = 0
upsample_mask_bwd.launches = 0
