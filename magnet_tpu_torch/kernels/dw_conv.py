"""Stride-1 depthwise KxK convolution with TF-SAME padding, NHWC.

The port of ``magnet_tpu/kernels/dwconv_pallas.py::dw_conv_pallas``, the
EfficientNet trunk's stride-1 ``conv_dw`` at eval: ``out[n, y, x, c] =
sum_{dy, dx} x[n, y + dy - pt, x + dx - pl, c] * w[dy, dx, c]`` with
``pt = pl = (K - 1) // 2`` (TF-SAME at stride 1), zero outside the image,
no bias, f32 accumulation, one rounding to x's dtype. The CUDA kernel
(``csrc/dw_conv.cu``, K = 3 or 5) loads each output tile's input and halo
into shared memory: in bf16 through a tensor map into a ring that
persistent blocks walk (the map's zero fill gives the padding), each thread
sliding its taps down a column of outputs in registers. Bounded by bytes on
an H100, see the source note. The TPU version's VMEM gates
(``choose_tile_h``, ``supported``) have no counterpart: every map size
runs.

``dw_conv_ref`` is the plain PyTorch version. ``dw_conv`` runs it for
tensors on the CPU and launches the kernel for tensors on a CUDA device, or
raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import OPS


def dw_conv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version. x: (N, H, W, C); w: (K, K, C). Returns (N, H, W, C)
    in x's dtype, computed in f32."""
    K, C = w.shape[0], w.shape[-1]
    pt = (K - 1) // 2
    xf = F.pad(x.permute(0, 3, 1, 2).float(), (pt, K - 1 - pt, pt, K - 1 - pt))
    out = F.conv2d(xf, w.float().permute(2, 0, 1)[:, None], groups=C)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def dw_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise conv with the arguments of ``dw_conv_ref``. CUDA
    tensors (f32 or bf16, x and w of one dtype, contiguous, C a multiple of
    16 bytes, K 3 or 5) launch the kernel on the current stream through
    ``ops.dw_conv``."""
    if x.device.type == "cpu":
        return dw_conv_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv: unsupported device {x.device}")
    return OPS.dw_conv(x, w)


dw_conv.launches = 0
