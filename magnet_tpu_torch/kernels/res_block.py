"""One stride-1 PSM-Net BasicBlock in one launch, NHWC.

The port of ``magnet_tpu/kernels/resstream_pallas.py::resblock_stream``,
the F-Net's path for maps too large for the whole-map chains (the KITTI
shape): ``out = bn2(conv2(relu(bn1(conv1(x))))) + x``, both convs 3x3 with
dilation d and padding d, eval BatchNorm folded to an f32 scale and shift, no
activation after the sum. The CUDA kernel (``csrc/res_block.cu``) computes
conv1 on a mid tile with its halo, keeps it in shared memory (zero outside
the image) and runs conv2 from there, so the mid map never reaches device
memory; bounded by tensor-core operations, see the source note. The TPU
version's gates (``_tile``, ``supported``) have no counterpart: every map
size runs, C up to 128, and in bf16 (the Hopper kernel) dilation 1 or 2, the
TPU kernel's. In bf16 the kernel reads both convs' weights as
``psm_blocks.pack_weights`` packs them (``pack_chain((w1, w2))``);
``nn.psmnet.PSMNet`` keeps them and passes ``packed``, else each call packs.

``res_block_ref`` is the plain version: the two convs of
``psm_blocks._conv_ref``, the mid map rounded to x's dtype. ``res_block``
runs it for tensors on the CPU and launches the kernel for tensors on a CUDA
device, or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from magnet_tpu_torch.kernels.ops import OPS
from magnet_tpu_torch.kernels.psm_blocks import _conv_ref, pack_chain

DILATIONS = (1, 2)   # the bf16 kernel's


def res_block_ref(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                  t1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                  t2: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Plain version. x: (N, H, W, C); w1, w2: (3, 3, C, C) HWIO; s*, t*:
    (C,) f32 folded BN. Returns (N, H, W, C) in x's dtype."""
    mid = _conv_ref(x, w1, s1, t1, 1, dilation, True, None)
    return _conv_ref(mid, w2, s2, t2, 1, dilation, False, x)


def res_block(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
              t1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
              t2: torch.Tensor, dilation: int = 1,
              packed: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
    """The block with the arguments of ``res_block_ref``. CUDA tensors (f32
    or bf16, C a multiple of 16 bytes and at most 128; in bf16 a dilation of
    1 or 2) launch the kernel on the current stream through
    ``ops.res_block``. ``packed``: ``pack_chain((w1, w2))``, made once by
    the caller (read in bf16 on a CUDA device; packed here when None)."""
    if x.device.type == "cpu":
        return res_block_ref(x, w1, s1, t1, w2, s2, t2, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"res_block: unsupported device {x.device}")
    wk1, wk2 = w1, w2
    if x.dtype == torch.bfloat16:
        if packed is None:
            packed = pack_chain((w1, w2))
        if len(packed) != 2:
            raise ValueError("res_block: packed holds both convs' weights")
        wk1, wk2 = packed
    return OPS.res_block(x, wk1, s1, t1, wk2, s2, t2, dilation)


res_block.launches = 0
