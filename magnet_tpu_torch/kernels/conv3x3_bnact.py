"""SAME 3x3 conv over [x | skip] + folded BatchNorm + LeakyReLU, NHWC.

The port of two TPU kernels: ``magnet_tpu/kernels/convstream_pallas.py``
(``conv3x3_stream`` / ``up2_fused``, D-Net decoder stage up2) and
``magnet_tpu/kernels/upstage_pallas.py`` (``upstage_fused``, stage up3).
One CUDA source (``csrc/conv3x3_bnact.cu``) serves both: a GEMM whose K
range runs over x and then over the skip, so the channel concat is never
built, and which in upsample mode reads x at half resolution and forms each
align_corners bilinear value on its way into shared memory. The epilogue is
``y = acc * scale + shift`` (conv bias folded into the shift) and an
optional LeakyReLU(0.01). Bounded by tensor-core operations on an H100.

bf16 runs the Hopper kernel: a block owns a patch of output pixels, stages
the patch's halo once per 64-channel block and lets all nine taps read it
(wgmma on shared-memory descriptors), while a producer warp streams the
weights through a ring of shared-memory stages with the bulk-copy engine.
It reads the weights in the layout of ``pack_weights``; callers that run
the conv more than once (``nn.densedepth.UpSampleBN``) pack them once and
pass ``packed``. f32 runs an FMA implicit GEMM on HWIO weights, equal to a
full-precision reference. The source note gives the design.

``conv3x3_bnact_ref`` is the plain PyTorch version of the same function.
``conv3x3_bnact`` runs it for tensors on the CPU and launches the kernel for
tensors on a CUDA device, or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import OPS
from magnet_tpu_torch.kernels.psm_blocks import swizzle_rows
from magnet_tpu_torch.ops.resample import resize_bilinear_align_corners

KC = 64    # input channels per K block of the bf16 kernel
NPAD = 256   # its output channels are padded to a multiple of this


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def packed_shape(cx: int, cs: int, cout: int) -> tuple:
    """Shape of ``pack_weights``' result for Cx, Cs input and Cout output
    channels."""
    return ((_ceil(cx, KC) + _ceil(cs, KC)) // KC, 9, _ceil(cout, NPAD), KC)


def pack_weights(w: torch.Tensor,
                 w_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The HWIO weights of x (3, 3, Cx, Cout) and of the skip (3, 3, Cs,
    Cout) in the layout the bf16 kernel reads: (K blocks, 9 taps, Cout
    padded to 256, 64). K block b holds input channels [64 b, 64 b + 64) of
    x, then of the skip; row [b, t, n] holds the weights of those channels
    to output n at tap t = 3 kh + kw, its 16-byte chunks swizzled
    (chunk c at c ^ (n % 8)), so that 128 rows from a multiple of 8 are one
    wgmma operand slab in the 128-byte swizzle layout. Padding is zero."""
    cout = w.shape[-1]
    blocks = []
    for t in (w, w_skip):
        if t is None:
            continue
        c = t.shape[2]
        cp = _ceil(c, KC)
        t = F.pad(t, (0, _ceil(cout, NPAD) - cout, 0, cp - c))
        blocks.append(t.reshape(9, cp // KC, KC, -1).permute(1, 0, 3, 2))
    return swizzle_rows(torch.cat(blocks)).contiguous()


def unpack_weights(packed: torch.Tensor, cx: int, cs: int, cout: int
                   ) -> tuple:
    """The HWIO (w, w_skip) that ``pack_weights`` packed (w_skip None when
    cs is 0)."""
    rows = swizzle_rows(packed)

    def hwio(blocks, c):
        return blocks.permute(1, 0, 3, 2).reshape(3, 3, -1, blocks.shape[2])[
            :, :, :c, :cout]
    nxb = _ceil(cx, KC) // KC
    return (hwio(rows[:nxb], cx), hwio(rows[nxb:], cs) if cs else None)


def conv3x3_bnact_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, skip: Optional[torch.Tensor] = None,
                      w_skip: Optional[torch.Tensor] = None,
                      upsample: bool = False, act: bool = True
                      ) -> torch.Tensor:
    """Plain version. x: (N, Hs, Ws, Cx); skip: (N, H, W, Cs) or None;
    w: (3, 3, Cx, Cout) and w_skip: (3, 3, Cs, Cout), HWIO; scale, shift:
    (Cout,) f32. upsample: resize x to the skip's (H, W) first
    (align_corners=True). Computes in f32 and returns x.dtype."""
    f32 = torch.float32
    xf = x.to(f32)
    if upsample:
        xf = resize_bilinear_align_corners(xf, skip.shape[1], skip.shape[2])
    acc = F.conv2d(xf.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(f32),
                   padding=1)
    if skip is not None:
        acc = acc + F.conv2d(skip.permute(0, 3, 1, 2).to(f32),
                             w_skip.permute(3, 2, 0, 1).to(f32), padding=1)
    y = acc * scale.to(f32)[:, None, None] + shift.to(f32)[:, None, None]
    if act:
        y = F.leaky_relu(y, 0.01)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_bnact(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, skip: Optional[torch.Tensor] = None,
                  w_skip: Optional[torch.Tensor] = None,
                  upsample: bool = False, act: bool = True,
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LeakyReLU((conv3x3(up(x)) + conv3x3(skip)) * scale + shift), with the
    arguments of ``conv3x3_bnact_ref``. CPU tensors take the plain version;
    CUDA tensors (f32 or bf16, channels a multiple of 16 bytes) launch the
    kernel on the current stream through ``ops.conv3x3_bnact``. ``packed``:
    ``pack_weights(w, w_skip)``, made once by the caller (bf16 on a CUDA
    device only; packed here when None)."""
    if x.device.type == "cpu":
        return conv3x3_bnact_ref(x, w, scale, shift, skip, w_skip, upsample,
                                 act)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bnact: unsupported device {x.device}")
    wx, ws = w, w_skip
    if x.dtype == torch.bfloat16:
        wx, ws = (pack_weights(w, w_skip) if packed is None else packed), None
    return OPS.conv3x3_bnact(x, skip, wx, ws, scale, shift, upsample, act)


conv3x3_bnact.launches = 0
