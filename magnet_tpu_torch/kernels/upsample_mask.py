"""Learned convex upsampling by k, NHWC.

The port of ``magnet_tpu/kernels/upsample_pallas.py::
upsample_via_mask_pallas``: each full-resolution pixel is a softmax-weighted
convex combination of the zero-padded 3x3 coarse neighbourhood of its parent
pixel. The mask channel index is ``c = j * k * k + ki * k + kj`` with
``j = ky * 3 + kx`` (the reference's ``view(N, 1, 9, k, k, H, W)``). The CUDA
kernel (``csrc/upsample_mask.cu``) does the softmax, the combine and the
k x k pixel shuffle in one pass; bounded by bytes on an H100, see the source
note.

``upsample_mask_ref`` is the plain PyTorch version. ``upsample_mask`` runs it
for tensors on the CPU and launches the kernel for tensors on a CUDA device,
or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def upsample_mask_ref(depth: torch.Tensor, up_mask: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Plain version. depth: (B, H, W, C); up_mask: (B, H, W, 9*k*k).
    Returns (B, k*H, k*W, C) in depth's dtype, computed in f32."""
    B, H, W, C = depth.shape
    mask = up_mask.float().reshape(B, H, W, 9, k, k).softmax(dim=3)
    # (B, C*9, H*W) zero-padded 3x3 neighbourhoods, j = ky*3 + kx
    nb = F.unfold(depth.float().permute(0, 3, 1, 2), 3, padding=1)
    nb = nb.reshape(B, C, 9, H, W).permute(0, 3, 4, 2, 1)  # (B,H,W,9,C)
    out = torch.einsum("bhwjkl,bhwjc->bhkwlc", mask, nb)
    return out.reshape(B, H * k, W * k, C).to(depth.dtype)


def upsample_mask(depth: torch.Tensor, up_mask: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Convex upsampling with the arguments of ``upsample_mask_ref``. CPU
    tensors take the plain version; CUDA tensors (f32 or bf16, depth and
    mask of one dtype) launch the kernel on the current stream."""
    if depth.device.type == "cpu":
        return upsample_mask_ref(depth, up_mask, k)
    if depth.device.type != "cuda":
        raise ValueError(f"upsample_mask: unsupported device {depth.device}")
    dt, dev = depth.dtype, depth.device
    if dt not in _DTYPES:
        raise ValueError(f"upsample_mask: unsupported dtype {dt}")
    if depth.dim() != 4 or not depth.is_contiguous():
        raise ValueError("upsample_mask: depth must be contiguous "
                         "(B, H, W, C)")
    B, H, W, C = depth.shape
    if (tuple(up_mask.shape) != (B, H, W, 9 * k * k) or up_mask.dtype != dt
            or up_mask.device != dev or not up_mask.is_contiguous()):
        raise ValueError(f"upsample_mask: up_mask must be contiguous "
                         f"{(B, H, W, 9 * k * k)} {dt} on {dev}")
    out = torch.empty((B, H * k, W * k, C), dtype=dt, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.mt_upsample_mask(
            _DTYPES[dt], depth.data_ptr(), up_mask.data_ptr(),
            out.data_ptr(), B, H, W, C, k,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "upsample_mask")
    upsample_mask.launches += 1
    return out


upsample_mask.launches = 0
