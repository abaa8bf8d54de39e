"""Fused tail of PSM-Net: conv3x3 over [raw | skip | branches] -> 128, folded
eval BatchNorm, ReLU, 1x1 projection (no bias) to the feature width. NHWC.

The port of ``magnet_tpu/kernels/spptail_pallas.py::spp_tail_fused``. The
CUDA kernel (``csrc/spp_tail.cu``) reads the three maps as K blocks of one
conv, so the 320-channel concat is never built, and keeps the 128-channel
hidden tile on chip, so only the projected features reach device memory.
Bounded by tensor-core operations on an H100; see the source note.

In bf16 the kernel reads the weights that ``tail_operands`` packs: the 3x3
in 64-channel K blocks per map (each map padded with zeros to its own K
blocks), the 1x1 in two K blocks with its columns padded to 128.
``nn.psmnet.PSMNet`` keeps them and passes ``packed``; else each call packs.
In f32 it reads the HWIO weights.

``spp_tail_ref`` is the plain PyTorch version. ``spp_tail`` runs it for
tensors on the CPU and launches the kernel for tensors on a CUDA device, or
raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import OPS
from magnet_tpu_torch.kernels.psm_blocks import _ceil, pack_weights

HIDDEN = 128
KBLOCK = 64        # input channels of a K block of the bf16 kernel
MAX_KBLOCKS = 16   # K blocks the bf16 kernel takes, over the three maps
MAX_OUT = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def spp_tail_ref(raw: torch.Tensor, skip: torch.Tensor, br: torch.Tensor,
                 w0: torch.Tensor, scale0: torch.Tensor,
                 shift0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Plain version. raw: (N, H, W, C0); skip: (N, H, W, C1); br: (N, H,
    W, C2); w0: (3, 3, C0 + C1 + C2, 128) HWIO, input channels in that
    order; scale0, shift0: (128,) f32 folded BN; w1: (128, Cout). The hidden
    activation rounds to raw.dtype before the projection, as the kernel's
    does; each conv accumulates in f32."""
    f32 = torch.float32
    cat = torch.cat([raw, skip, br], -1).permute(0, 3, 1, 2).to(f32)
    acc = F.conv2d(cat, w0.permute(3, 2, 0, 1).to(f32), padding=1)
    y = F.relu(acc * scale0.to(f32)[:, None, None]
               + shift0.to(f32)[:, None, None]).to(raw.dtype)
    out = F.conv2d(y.to(f32), w1.t().to(f32)[:, :, None, None])
    return out.permute(0, 2, 3, 1).to(raw.dtype).contiguous()


def tail_operands(w0: torch.Tensor, w1: torch.Tensor,
                  widths: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's weights: w0 (3, 3, sum(widths), 128) HWIO, its
    input channels the maps' of ``widths`` in order, packed per map
    (``pack_weights`` in K blocks of 64, each map zero padded to its own K
    blocks) and the maps' K blocks concatenated: (K blocks, 9, 128, 64); w1
    (128, Cout) as a 1x1 in two K blocks, (2, 1, Cout padded to 128, 64)."""
    parts, off = [], 0
    for c in widths:
        parts.append(pack_weights(w0[:, :, off:off + c], kb=KBLOCK,
                                  n_pad=HIDDEN))
        off += c
    if off != w0.shape[2]:
        raise ValueError(f"spp_tail: widths {tuple(widths)} for "
                         f"{w0.shape[2]} input channels")
    return (torch.cat(parts), pack_weights(
        w1[None, None], kb=KBLOCK, n_pad=_ceil(w1.shape[-1], HIDDEN)))


def spp_tail(raw: torch.Tensor, skip: torch.Tensor, br: torch.Tensor,
             w0: torch.Tensor, scale0: torch.Tensor, shift0: torch.Tensor,
             w1: torch.Tensor,
             packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> torch.Tensor:
    """The tail with the arguments of ``spp_tail_ref``. CPU tensors take the
    plain version; CUDA tensors (f32 or bf16, every channel count a multiple
    of 16 bytes, Cout a multiple of 16 and at most 256) launch the kernel on
    the current stream through ``ops.spp_tail``. ``packed``:
    ``tail_operands(w0, w1, (C0, C1, C2))``, made once by the caller (read
    in bf16 on a CUDA device; packed here when None)."""
    if raw.device.type == "cpu":
        return spp_tail_ref(raw, skip, br, w0, scale0, shift0, w1)
    if raw.device.type != "cuda":
        raise ValueError(f"spp_tail: unsupported device {raw.device}")
    dt, dev = raw.dtype, raw.device
    if dt not in _DTYPES:
        raise ValueError(f"spp_tail: unsupported dtype {dt}")
    N, H, W, C0 = raw.shape
    C1, C2 = skip.shape[-1], br.shape[-1]
    cout = w1.shape[-1]
    vec = 16 // raw.element_size()
    if C0 % vec or C1 % vec or C2 % vec:
        raise ValueError(f"spp_tail: channels ({C0}, {C1}, {C2}) must be "
                         f"multiples of {vec}")
    if cout % 16 or cout > MAX_OUT:
        raise ValueError(f"spp_tail: Cout={cout} must be a multiple of 16, "
                         f"at most {MAX_OUT}")
    wk0, wk1 = w0, w1
    if dt == torch.bfloat16:
        wk0, wk1 = (tail_operands(w0, w1, (C0, C1, C2)) if packed is None
                    else packed)
    return OPS.spp_tail(raw, skip, br, wk0, scale0, shift0, wk1, cout)


spp_tail.launches = 0
